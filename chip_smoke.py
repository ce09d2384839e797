#!/usr/bin/env python3
"""Drive the PyTorch port (purejaxql_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                    # from the root of a checkout, one GPU
    python3 chip_smoke.py --learning-bars    # the same, the gated runs at their bars' lengths

Run with no arguments, every run below that carries a learning gate trains
at full width for 16 updates (MemoryChain's for 8) through all of its
other checks, and its bar's numbers are printed but not held; with
--learning-bars each trains for its JAX test's length, as given below, and
is held to its bar (the Pendulum gate's seeds past 0 then run in worker
processes). Phases, each ending the run with a non-zero exit if it fails:

1. identify the card (nvidia-smi name and power limit, torch/CUDA/nvcc);
2. build the CUDA kernels under purejaxql_torch/csrc/ (one nvcc each, in
   parallel) into build/purejaxql_torch/;
3. hold each kernel against its plain PyTorch twin on the card, at the
   trainers' shapes: the lambda returns in both forms (gymnax and closure,
   at the trainers' shapes, short, ragged and long ones, each also with
   NaN and infinities in max_qs and rewards), the CartPole cluster rollout (PRNG off
   and on, at the trainer's two shapes and at ragged shapes that force
   resets, each with its plan, register counts and the clusters the card
   places at once; a Q-row with a NaN), the Breakout,
   Asterix, Freeway, SpaceInvaders and Seaquest rollouts (PRNG off and on;
   Seaquest also at a shape that forces resets; the five kernels on the
   cluster CNN also at a ragged shape, each with its plans, register counts
   and the clusters the card places at once, and with a NaN in every
   Q-row; Seaquest also through its cash-ins), the GRU
   scan's forward and backward cluster kernels at seven shapes (VDN's
   Spread and SMAX windows among them), each with its launch plan and the
   kernels' register and spill counts (and autograd through them), and the
   Pendulum actor-critic cluster rollout (PRNG off and on, at the trainer's
   shape, at one that forces resets and at a ragged one whose W2 slices are
   read from L2, each with its plan and register counts), and the
   epsilon-greedy kernel (bit for bit, at
   the Craftax trainer's shape and two others, the seeded, host and classic
   envs' rows among them, at eps 0, 0.3 and 1, with a
   tied and a NaN row, and on edge rows: signed zeros, NaN payloads,
   infinities);
4. check the kernels' random streams by their statistics (Seaquest: the
   coin, and one step of 8192 envs that fire, are shot at and spawn;
   epsilon-greedy: P(random), a uniform histogram at eps 1);
5. train pqn_cartpole at full width (H 256, 32 envs x 64 steps, 16
   minibatches x 4 epochs, greedy eval 128 envs x 500 steps) for 200k env
   steps through the CLI's entry point, with the launch counters zeroed just
   before and read just after, and check that it learned (the gated runs:
   16 updates without --learning-bars);
6. train pqn_minatar at full width (the MinAtar CNN, 128 envs x 32 steps,
   32 minibatches x 2 epochs, greedy eval 128 envs x up to max_steps) the
   same way: Breakout-MinAtar for 500k env steps and Asterix-MinAtar (the
   YAML's default game, no ENV_NAME) for 500k, each checked for learning,
   then Freeway-MinAtar and SpaceInvaders-MinAtar for 16 updates each, and
   Seaquest-MinAtar for 500k, its launches within the range its eval allows
   and checked against its gate;
6d. train pqn_rnn_memory_chain at its full config (GRU H 256, 32 envs x 128
   steps, window 4, 16 minibatches x 4 epochs, 1e5 env steps, greedy eval
   128 envs x 64 steps) through the GRU scan kernels and the closure form
   of the returns kernel (one launch of each a grad step) and check that it
   remembers; the FF trainer on the same config must not; then
   pqn_rnn_cartpole at full width for 16 updates; both recurrent runs take
   every action of their prefill and rollouts from the epsilon-greedy kernel
   (the cuda policy's EXPLORATION_KERNEL);
6e. train pqn_pendulum at full width (actor and two critics H 256, 64 envs x
   32 steps, 8 minibatches x 4 epochs, greedy eval 64 envs x 200 steps every
   10 % of the run) for 400k env steps through the Pendulum kernel; its
   learning gate is held over seeds (below, before phase 7);
6e'. train the actor-critic trainer beyond Pendulum, unfused, each update's
   Q(lambda) targets through the returns kernel and no other kernel:
   pqn_reacher (Reacher, 64 envs, no normalizer: the one-seed path with
   no observation statistics), pqn_dm_suite (CartPoleSwingUp, 128 envs,
   NORMALIZE_OBS),
   pqn_locomotion (Hopper, 256 envs, both normalizers) and pqn_manipulation
   (Pusher, 256 envs, actor 256 x 128, critics 512 x 512, both normalizers)
   at full width for 8 updates each with 2 greedy evals of the episode
   limit (150, 500, 1,000 and 150 steps); each run's env-step count, parameters
   on cuda, finite metrics, the observation statistics' count 1e-4 +
   E (1 + updates x NUM_STEPS) in float32, and the saved tree with
   norm_stats (obs_dim,) beside the actor's and the critics' Dense kernels;
   the learning gate of Pendulum is held over seeds: seed 0 is the run
   above, the other seeds run in worker processes
   (scripts/ac_learning_bar.py, one a seed) beside phases 6e-6j, and the
   best greedy eval over the seeds must beat the JAX test's one-run bar
   (-500, random play about -1300), as a single seed learns past it in
   about half of the runs; the workers are waited for before phase 7, so
   that no kernel is timed beside them (pqn_reacher's run and gate are
   phase 6j's, 4 seeds as one program);
6f. train pqn_craftax at full width (Forager, H 1024 x 4 with an input
   BatchRenorm, 1024 envs x 1 step, resets at ratio 16, 1-step TD) for 2^18
   env steps, the YAML unchanged, so the cuda policy gives it the fast
   program: RESET_BANK=256 (the reset bank, refreshed every 16 steps),
   FAST_TARGETS and SKIP_NOOP_PERMUTE. Every action of the training rollout
   from the epsilon-greedy kernel (one launch an update), no other kernel,
   the bank's refresh bursts counted (one every 16 updates), finite
   metrics, episodes ending, the saved flax tree, env-steps/s and the
   done-masked returns of its last 10 % printed (no learning bar: at this
   length learned and LR=0 runs do not separate, PERF.md section 7); then
   the strict program (PARITY=strict with the epsilon-greedy kernel:
   optimistic resets, concat 1-step TD, a permuted minibatch) for 2^18
   steps; then pqn_craftax with BF16_COMPUTE for 2^18 steps, its trunk's
   activations bfloat16 (forward hooks) and its parameters float32, and
   its bfloat16 forward held within BF16_BOUND of the float32 forward on the
   same weights at H 1024 x 4 and batch 1024; then Breakout-MinAtar with
   BF16_COMPUTE for 16 updates through the fused Breakout kernel (which
   reads the float32 master weights);
6g. train pqn_vdn_spread at full width (3 agents, one GRU network H 256
   shared by all, 128 envs x 25 steps, window 4, 8 minibatches x 2 epochs,
   greedy eval 128 envs x 25 steps every 5 % of the run) for the YAML's 1e6
   env steps through the GRU scan kernels and the closure form of the
   returns kernel, one launch of each a grad step at VDN's shapes (T 29,
   rows 48; targets (28, 16)), and check that it learned (the JAX package's
   bar: the last tenth of updates' mean team return above the first
   tenth's by more than 3); then pqn_vdn_smax (Skirmish 2s3z, 5 agents,
   rows 80), pqn_vdn_kitchen and pqn_vdn_hanabi at full width for 8
   updates each through the same kernels;
6h. train pqn_rnn_craftax at full width (Forager, one dense layer H 512 with
   LayerNorm, an LSTM layer H 512 with the last action as input, an input
   BatchRenorm, 1024 envs x 128 steps, resets at ratio 16, 4 epochs x 4
   minibatches of truncated BPTT over the 128-step window, done-masked info
   metrics) for 3 updates, the YAML's decay kept, so the cuda policy gives it
   FAST_BPTT (the LSTM loop in PyTorch), the epsilon-greedy kernel and the
   reset bank: one epsilon-greedy launch a step of the prefill and of the
   rollouts (128 x 4), one closure returns launch a grad step (48), no other
   kernel, the banked env state, the input BatchRenorm's step count, finite
   metrics and the saved flax tree (OptimizedLSTMCell_0's eight kernels);
   then one update in the strict program (PARITY=strict: optimistic resets,
   the module path) and one with BF16_COMPUTE, whose BPTT forward is held
   within BF16_BOUND of the float32 one on the same weights;
6i. train S seeds as one program (NUM_SEEDS, algo/seeds.py): pqn_cartpole
   with 8 seeds for 200k env steps a seed (the epsilon-greedy kernel a
   rollout step, the returns an update, as one seed: the mean over seeds of
   each seed's last-10 return above the single-seed gate, the lanes' params
   apart, (8, NUM_UPDATES) metrics, one checkpoint a seed); pqn_cartpole
   with 64 seeds, PARITY=strict, for 16 updates (bench.py's
   cartpole_seeds64: its aggregate rate beside the single-seed strict
   run's); Breakout-MinAtar with 4 seeds for 16 updates, unfused; and
   pqn_rnn_memory_chain with 4 seeds for 1e5 env steps a seed, each GRU
   scan kernel and the closure returns launched once a grad step for all 4
   seeds (the mean over seeds of the last-3 greedy eval above 0.8, the
   per-seed checkpoints read back); before them (3e') the seeded GRU scan
   kernels against their twins at the seeded windows (T 132 and 68, 4
   seeds of B 2; T 29, 4 seeds of VDN's 24 rows at H 128) and lane s
   against the unseeded launch, bit for bit;
6j. the other families with seeds as one program, each through the CLI,
   its lanes' numbers and its aggregate rate printed: pqn_craftax with 4
   seeds in the fast program for 2^18 env steps a seed (a reset bank of 256
   a seed, FAST_TARGETS under each lane's frozen statistics, every action of
   the 4 x 1024 rows from one epsilon-greedy launch an update, as many
   launches as phase 6f's one seed of the same length, whose rate is set
   beside it; each lane's BatchRenorm stepped once a grad step, finite
   metrics, lanes apart, one checkpoint a seed), then 16 updates of it with
   BF16_COMPUTE (each lane's bfloat16 forward within BF16_BOUND of its
   float32 one); pqn_rnn_craftax with 2 seeds for 3 updates of the fast
   program (one seed's launches); pqn_vdn_spread with 4 seeds at the JAX
   bar's settings (400k env steps a seed, 64 envs, H 128, no eval), each
   GRU scan kernel and the closure returns launched once a grad step as for
   one seed, and at least 3 of the 4 lanes' last tenth above their first by
   3; pqn_reacher with 4 seeds for 400k env steps a seed (the returns once
   an update over (32, 4 x 64) columns), the best greedy eval over the
   lanes above -70; pqn_locomotion with 2 seeds for 8 updates with both
   normalizers: statistics (2, obs_dim), the seeds' apart, each seed's file
   holding its own norm_stats;
6k. the host-env path (pqn_host), after the AC gate's workers have ended:
   the port's C++ envhost and its four plug-in builds compiled with g++
   (their build times), the pool's host env-steps/s over 200 steps of 144
   envs with random actions on CartPole-v1, Acrobot-v1, the five MinAtar
   games, Pong-EH, PongRam-EH, Breakout-EH and BreakoutRam-EH, the exchange
   buffers pinned (when a Pong-EH obs copy returns and when it lands);
   pqn_host_minatar as the YAML stands (Breakout-MinAtar, the MinAtar CNN,
   128 + 16 test envs x 32 steps, 32 minibatches x 2 epochs) for 16 updates
   and on Pong-EH with the Nature CNN (84x84x4) for 8, each sync and with
   ASYNC_ENVS, their env-steps/s side by side: one epsilon-greedy launch a
   rollout step over the training rows (32 an update), one closure returns
   launch an update, no other kernel, the env-step count, finite metrics
   with the test/* keys, parameters on cuda, the saved tree; then the
   learning gate of tests/test_pqn_host.py:36-55 on host CartPole (200k
   env steps, 64 envs x 32 steps): the last tenth's done rate below half
   the first tenth's (the PongRam-EH bar of tests/test_pong_plugin.py,
   1.2M env steps, runs in scripts/host_learning_bar.py);
6l. the single-file classic envs: each of their 22 registry names built on
   the card and stepped 16 times with random actions over 128 envs (finite
   obs and rewards), each task's raw step_env time beside its step through
   the trainer's wrappers; pqn_cartpole at full width (H 256, 32 envs x 64
   steps, 16 minibatches x 4 epochs, greedy eval 128 envs at the start and
   the end) for 16 updates on Acrobot-v1, MountainCar-v0,
   Catch-bsuite and DeepSea-bsuite: 64 epsilon-greedy launches and one
   returns launch an update (the cuda policy's EXPLORATION_KERNEL), no
   other kernel, the env-step count, finite metrics with the test/* keys,
   the saved tree; pqn_dm_suite at full width for 8 updates on one task of
   each dm-suite module (AcrobotSwingup, PointMass, SwimmerSwimmer6,
   CheetahRun, FingerTurnEasy, FishSwim), without evals, with 6e''s checks; the learning
   bars of these envs run in scripts/classic_learning_bar.py;
6m. the shared simulators, locomotion3d and manipulation2d: each of their 33
   registry names built on the card and stepped 16 times with random
   actions over 128 envs (finite obs and rewards, the obs shape), each
   (class, task)'s raw step_env time beside its step through the AC
   trainer's wrappers; pqn_locomotion at full width (actor and two critics
   H 256 x 2, 256 envs x 32 steps, 8 minibatches x 4 epochs) on
   Go1JoystickFlatTerrain and HumanoidWalk without evals (1,000-step
   episodes), pqn_manipulation (actor [256, 128], critics [512, 512]) on a
   task of each of the six manipulation classes, PegInsert-v0 with its two
   evals, each for SIM_UPDATES (4) updates with 6e''s checks (one returns
   launch an update, no other kernel); the learning runs of these envs are
   scripts/classic_learning_bar.py's peg_insert, go1 and humanoid_walk;
6n. every network configuration the JAX modules take, through the normal
   entry points at the YAMLs' full widths, NETWORK_UPDATES (2) updates each
   without evals (pqn_craftax, one env step an update, NETWORK_CRAFTAX_UPDATES):
   pqn_minatar Breakout NORM_TYPE=batch_norm, SpaceInvaders
   NORM_TYPE=batch_renorm BF16_COMPUTE, Breakout batch_norm with
   NUM_SEEDS=2 (unfused: one epsilon-greedy launch a rollout step, one
   returns launch an update); pqn_craftax NORM_TYPE=batch_norm BF16_COMPUTE
   (a BatchRenorm trunk in bfloat16; 1-step TD, so no returns launch);
   pqn_rnn_cartpole NORM_TYPE=batch_norm and pqn_rnn_craftax
   NORM_TYPE=batch_norm (an LSTM on a BatchRenorm trunk), on the module path
   (no FAST_BPTT, no GRU kernel; epsilon-greedy on the prefill and every
   rollout step, one closure returns launch a grad step); pqn_vdn_spread
   RNN_CELL=lstm and pqn_vdn_smax NORM_TYPE=batch_norm (one closure
   returns launch a grad step, nothing else); pqn_host_minatar on Pong-EH
   with the Nature trunk, BF16_COMPUTE and NORM_TYPE=batch_norm, sync and
   ASYNC_ENVS; each run's env-steps/s, launches, and the largest difference
   between its trained network's forward on the card and on a CPU copy;
6o. the staged API and its tooling at full width: the stepwise CLI
   (TRAINER=stepwise) on pqn_cartpole for 8 updates with CHECKPOINT_EVERY=4,
   then RESUME_FROM its state to 12 (one epsilon-greedy launch a rollout
   step, one returns launch an update; the state file round-trips bit for
   bit); the rollout tool on the stepwise run's weights and with --gif on
   the saved Breakout run; train_segmented against one train on pqn_cartpole
   fused (4 segments of 4 updates: one CartPole rollout and one returns
   launch an update) and on pqn_rnn_memory_chain (2 segments of 1: the GRU
   scan kernels and the closure returns a grad step), the counters equal
   and the params bit-equal or within 1e-5 (the gap printed); with
   --learning-bars also tests/test_segmented.py's CartPole learning check at
   its length; LOG_VIA_CALLBACK=True LOG_INTERVAL=2 on pqn_cartpole,
   pqn_rnn_memory_chain, pqn_vdn_spread and pqn_pendulum for 4 updates each
   (2 finite rows each); HYP_TUNE with 2 trials of 4 updates; the stage
   timings (ms a stage, the stages' unfused rollout at full width);
6p. the sharded trainers (parallel/spmd.py) at the YAMLs' global widths:
   2 ranks of one gloo group on cuda:0, started once (torch.multiprocessing,
   a file store under build/), run pqn_cartpole unfused (epsilon-greedy, the
   returns) and fused (the CartPole kernel, its evals: 16 updates, with
   --learning-bars tests/test_pqn_train.py::test_cartpole_learns's 200k held
   to its bar, the last-10 mean above 100), Breakout fused, pqn_rnn_cartpole
   (the GRU scan kernels, the closure returns), pqn_vdn_spread, Pendulum
   fused, pqn_cartpole with NORM_TYPE=batch_norm NORM_INPUT=True (the
   statistics over the group), train_segmented_spmd in 2 segments against
   one make_train_spmd_resumable run (bit-equal), and one run on an nccl
   group of world size 1 on rank 0; then make_train_spmd_seeds on a (2, 2)
   mesh of 4 ranks (each seed row's params its own). Each run: the global
   timestep counter, the replicas' params and batch statistics bit-equal
   (the largest gap printed), finite metrics, each rank's launches against
   the single-process formula at its local shapes, the wall, per-rank and
   aggregate env-steps/s beside one process's rate on the same global
   config, one gradient all-reduce's mean time (gloo staged through the
   host: nothing said of NCCL across cards);
7. time each kernel and its twin with CUDA events at the trainers' shapes
   (the GRU scan and the closure returns also at VDN's and the host
   trainer's (32, 64), and the seeded shapes: one seeded GRU launch against
   S unseeded ones, epsilon-greedy at 4 x 1024 and 2 x 1024 Craftax rows
   and the host trainer's (128, 3), (128, 6) and (64, 6), the returns at
   the seeded AC, VDN and pqn_rnn_craftax columns; epsilon-greedy also at
   the classic envs' (32, 3) and (32, 2)), and torch.nn.GRU (cuDNN) beside the
   GRU scan as a yardstick (S calls of it beside the seeded launch);
8. print the kernel table as one JSON line (the four kernels of phase 6j's
   runs at their seeded shapes, with those runs' launches, phases 6o's and
   6p's added, 6p's over every rank);
9. print {"ok": true, "device": {...}} as the last line.

It exits non-zero, printing no result, where no GPU is visible or where the
port's package is not beside it. What it builds and writes goes under build/.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time

# the card's published peaks used for the bounds (H100 SXM data sheet)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

# The runs that carry a learning gate train, with --learning-bars, for their
# JAX tests' lengths below and are held to their bars. Run with no
# arguments, each of them trains at full width for GATE_SHORT_UPDATES
# updates (MemoryChain's for MEMORY_SHORT_UPDATES) through the same checks,
# and its bar's numbers are printed, not held: the gated script took
# 975.9-1,006.3 s on an H100 beside its 1,200 s limit (PERF.md section 2)
GATE_SHORT_UPDATES, MEMORY_SHORT_UPDATES = 16, 8
TRAIN_STEPS = 200_000
BREAKOUT_STEPS = 500_000
ASTERIX_STEPS = 500_000
SEAQUEST_STEPS = 500_000
SHORT_STEPS = 16 * 32 * 128  # 16 updates of Freeway and of SpaceInvaders
MEMORY_STEPS = 100_000  # pqn_rnn_memory_chain.yaml's TOTAL_TIMESTEPS: 24 updates
VDN_SPREAD_STEPS = 1_000_000  # pqn_vdn_spread.yaml's TOTAL_TIMESTEPS: 312 updates
# tests/test_pqn_vdn.py::test_vdn_learns_spread: the last tenth of updates'
# mean returned_episode_returns above the first tenth's by more than this
VDN_SPREAD_GATE = 3.0
# the other VDN configs, 8 updates each at full width
VDN_SHORT = ("pqn_vdn_smax", "pqn_vdn_kitchen", "pqn_vdn_hanabi")
VDN_SHORT_UPDATES = 8
RNN_CARTPOLE_STEPS = 16 * 64 * 32  # 16 updates of pqn_rnn_cartpole
PENDULUM_STEPS = 400_000  # tests/test_pqn_ac.py::test_ac_learns_pendulum's length
# the best greedy eval return the Pendulum runs must beat (the same test's
# bar for one run; random play is about -1300)
PENDULUM_GATE = -500.0
# the Pendulum kernel at the trainer's shape (T, B, H, max_steps), at one
# that forces resets, and at ragged groups with the W2 slices read from L2
PENDULUM_SHAPES = ((32, 64, 256, 200), (40, 16, 64, 10), (12, 100, 1024, 5))
# the actor-critic trainer beyond Pendulum (unfused): the four YAMLs at one
# seed for 8 updates each, their eval every TEST_INTERVAL of the run;
# pqn_reacher with seeds (phase 6j) for tests/test_pqn_ac.py::
# test_ac_learns_reacher's 400k env steps, held to its bar on the best
# greedy eval (random play is about -129)
REACHER_STEPS = 400_000
REACHER_GATE = -70.0
# the seeds 0..n-1 that the Pendulum gate is held over: the best greedy
# eval over them beats the bar. At 400k env steps one seed learns past -500
# in a quarter to a half of the runs, in JAX as in the port (PERF.md section
# 7). Reacher's gate is held over the lanes of one 4-seed program (phase 6j)
AC_GATE_SEEDS = {"pendulum": 8}
# the workers' limit, from their start at phase 6e
AC_GATE_TIMEOUT_S = 900
AC_SHORT = ("pqn_reacher", "pqn_dm_suite", "pqn_locomotion", "pqn_manipulation")
AC_SHORT_UPDATES = 8
AC_SHORT_TEST_INTERVAL = 1.0  # 2 evals: at the start and after the last update
# the CartPole kernel at ragged groups that force resets (T, B, H,
# max_steps): a lone env, warps past the last env, W2 slices in shared
# memory and read from L2
CARTPOLE_RAGGED = ((24, 1, 64, 5), (24, 37, 256, 5), (24, 130, 512, 5), (24, 37, 1024, 5))
# the MinAtar kernels on the cluster CNN at ragged clusters (T, B, H,
# max_steps); the trainer's shape is phases 3c-3d's
CLUSTER_RAGGED = (24, 37, 256, 9)
# the last-3 mean greedy eval return on MemoryChain: above MEMORY_GATE for the
# recurrent trainer, below FF_GATE for the feedforward one
# (tests/test_pqn_rnn.py::test_rnn_solves_memory_task_ff_does_not)
MEMORY_GATE, FF_GATE = 0.8, 0.5
# the GRU scan at the trainers' shapes (T = MEMORY_WINDOW + NUM_STEPS, B =
# NUM_ENVS / NUM_MINIBATCHES, H; VDN's B = agents x NUM_ENVS /
# NUM_MINIBATCHES: Spread 3 x 16, SMAX 5 x 16), then at shapes of several
# clusters and at the largest H whose W_h slice stays in shared memory (a
# cluster of 16)
GRU_SHAPES = ((132, 2, 256), (68, 2, 256), (29, 48, 256), (68, 80, 256), (32, 16, 128), (20, 40, 256),
              (9, 2, 512))
# VDN's windows, timed beside the recurrent trainer's
GRU_VDN_TIMED = ((29, 48, 256), (68, 80, 256))
# the seeded recurrent trainer's windows (T, S, B, H): MemoryChain and RNN
# CartPole with 4 seeds of B 2 rows; VDN Spread with 4 seeds at the JAX
# bar's settings (phase 6j: H 128, 3 agents x 8 envs a seed's minibatch)
SEEDED_GRU_SHAPES = ((132, 4, 2, 256), (68, 4, 2, 256), (29, 4, 24, 128))
# the seeded runs (NUM_SEEDS): pqn_cartpole with 8 seeds, 200k env steps a
# seed, held to the single-seed CartPole gate by the mean over seeds of each
# seed's last-10 return; 64 seeds in the strict program (bench.py's
# cartpole_seeds64) and Breakout with 4 seeds for 16 updates; MemoryChain
# with 4 seeds, 1e5 env steps a seed, held to MEMORY_GATE by the mean over
# seeds of each seed's last-3 greedy eval
SEED_CARTPOLE, SEEDS64, SEED_BREAKOUT, SEED_MEMORY = 8, 64, 4, 4
SEEDS64_STEPS = 16 * 64 * 32
# the mean of the last 10 training returns the Asterix run must beat:
# tests/test_torch_asterix.py::test_asterix_learns
ASTERIX_GATE = 0.8
# the same for Seaquest: tests/test_torch_seaquest.py::test_seaquest_learns
SEAQUEST_GATE = 0.2
# pqn_craftax's run: 256 updates of 1024 envs x 1 step (the YAML's 1e9 cut
# to this length; 2,048 before the seeded phases came in, 1,024 before the
# seeded families'), the one-seed run beside phase 6j's 4 seeds of the same
# length. It has no learning bar: at 2^21 steps on an H100, one of four
# learned seeds ended above random play, three with the LR=0 runs
# (scripts/craftax_learning_bar.py, PERF.md sections 2 and 7)
CRAFTAX_STEPS = 2**18
# the strict Craftax program (PARITY=strict) and the bfloat16 one, shorter
CRAFTAX_STRICT_STEPS = 2**18
CRAFTAX_BF16_STEPS = 2**18
# pqn_rnn_craftax at full width (LSTM H 512, 1024 envs x 128 steps, 4 x 4
# grad steps an update): 3 updates in the fast program, the YAML's
# TOTAL_TIMESTEPS_DECAY of 1e9 kept; 1 in the strict program and 1 with
# BF16_COMPUTE
RNN_CRAFTAX_STEPS = 3 * 1024 * 128
RNN_CRAFTAX_SHORT_STEPS = 1024 * 128
# the bfloat16 forward against the float32 one on the same weights: the
# largest |difference| over the Q-values at most this share of the largest
# |Q| (bfloat16 keeps 8 significant bits; 0.7 % measured on the CPU at H 1024
# x 4 from the init, tests/test_torch_bf16.py)
BF16_BOUND = 0.03
# the seeded families (phase 6j, NUM_SEEDS as one program): pqn_craftax with
# 4 seeds in the fast program, CRAFTAX_STEPS a seed, beside phase 6f's one
# seed of the same length, then 16 updates with BF16_COMPUTE; pqn_rnn_craftax
# with 2 seeds, 3 updates fast; pqn_vdn_spread with 4 seeds at the JAX bar's
# settings (tests/test_pqn_vdn.py::test_vdn_learns_spread: 400k env steps a
# seed, 64 envs, H 128, no eval), at least SEED_VDN_PASS lanes past
# VDN_SPREAD_GATE; pqn_reacher with 4 seeds for REACHER_STEPS a seed, the
# best greedy eval over the lanes past REACHER_GATE (the bar once held over
# seeds 0-3 as separate runs); pqn_locomotion with 2 seeds for 8 updates,
# both normalizers, one statistics state a seed
SEED_CRAFTAX, SEED_CRAFTAX_BF16_UPDATES, SEED_RNN_CRAFTAX = 4, 16, 2
SEED_VDN, SEED_VDN_STEPS, SEED_VDN_PASS = 4, 400_000, 3
SEED_VDN_EXTRA = ("NUM_ENVS=64", "HIDDEN_SIZE=128", "TEST_DURING_TRAINING=False")
SEED_REACHER, SEED_LOCOMOTION = 4, 2
CRAFTAX_FAST_POLICY = (("EXPLORATION_KERNEL", "pallas"), "FAST_TARGETS", "SKIP_NOOP_PERMUTE", ("RESET_BANK", 256))
# this script's wall with --learning-bars on an NVIDIA H100 80GB HBM3 at
# 700 W, every phase through 6o and scripts/network_learning_bar.py
# included, the kernels already built (PERF.md section 2)
RECORDED_WALL_S = 1784.7
# the epsilon-greedy kernel at the Craftax trainer's shape (E, A) and two others
# and the seeded runs' folded rows (S x NUM_ENVS, A): CartPole with 8 and
# 64 seeds, Breakout with 4, Craftax with 4 and pqn_rnn_craftax with 2; the
# host trainer's rows; pqn_cartpole's 32 envs on Acrobot, MountainCar and
# Catch (3 actions) and DeepSea (2)
EPS_GREEDY_SHAPES = ((1024, 34), (1000, 34), (512, 6), (256, 2), (2048, 2), (512, 3), (4096, 34), (2048, 34),
                     (128, 3), (128, 6), (64, 6), (32, 3), (32, 2))
# the host-env trainer's training rows (NUM_ENVS, A): Breakout-MinAtar and
# Pong-EH at the YAML's 128 envs, PongRam-EH at the learning gate's 64
HOST_EPS_SHAPES = ((128, 3), (128, 6), (64, 6))
# phase 6k, the host-env path (pqn_host): the pool stepped with random
# actions at the YAML's 128 + 16 envs on every native game and bundled
# plug-in; pqn_host_minatar as the YAML stands (Breakout-MinAtar) and on
# Pong-EH with the Nature CNN, sync and ASYNC_ENVS; the learning gate of
# tests/test_pqn_host.py:36-55 on host CartPole (200k env steps, 64 envs x
# 32 steps, 8 minibatches x 2 epochs, no test envs: the last tenth's done
# rate below half the first tenth's). The PongRam-EH bar of
# tests/test_pong_plugin.py:124-155 (1.2M env steps) took 109 s of a 163 s
# phase on an H100: it runs in scripts/host_learning_bar.py
HOST_POOL_ENVS = ("CartPole-v1", "Acrobot-v1", "Breakout-MinAtar", "Asterix-MinAtar", "Freeway-MinAtar",
                  "SpaceInvaders-MinAtar", "Seaquest-MinAtar", "Pong-EH", "PongRam-EH", "Breakout-EH",
                  "BreakoutRam-EH")
HOST_POOL_STEPS = 200
HOST_BREAKOUT_UPDATES, HOST_PONG_UPDATES = 16, 8
HOST_GATE_STEPS = 200_000
HOST_GATE_EXTRA = ("ALG_NAME=pqn_host", "NUM_ENVS=64", "NUM_STEPS=32", "NUM_MINIBATCHES=8", "NUM_EPOCHS=2",
                   "TEST_DURING_TRAINING=False")
# phase 6l, the single-file classic envs: each of their registry names
# built on the card and stepped CLASSIC_STEP_STEPS times with random actions
# over CLASSIC_STEP_ENVS envs (a task's raw step_env timed beside its step
# through the trainer's wrappers); the four discrete envs trained at
# pqn_cartpole's full width for CLASSIC_FF_UPDATES updates (evals at the
# start and the end: Catch's and DeepSea's 2,000 steps each); one task of
# each dm-suite module at pqn_dm_suite's full width for AC_SHORT_UPDATES
# without evals (their 1,000-step evals took 23-46 s of CheetahRun's,
# Finger's and Fish's 34-56 s runs on an H100 80GB HBM3 at 700 W; phase 6l
# took 241.3 s with them and a 0.5 interval, PERF.md section 6)
CLASSIC_FF_ENVS = ("Acrobot-v1", "MountainCar-v0", "Catch-bsuite", "DeepSea-bsuite")
CLASSIC_AC_NAMES = (
    "AcrobotSwingup-v0", "AcrobotSwingupSparse-v0", "PointMass-v0", "SwimmerSwimmer6-v0", "CheetahRun-v0",
    "FingerSpin-v0", "FingerTurnEasy-v0", "FingerTurnHard-v0", "FishSwim-v0", "AcrobotSwingup", "AcrobotSwingupSparse",
    "PointMass", "SwimmerSwimmer6", "CheetahRun", "FingerSpin", "FingerTurnEasy", "FingerTurnHard", "FishSwim",
)
CLASSIC_AC_RUNS = ("AcrobotSwingup-v0", "PointMass-v0", "SwimmerSwimmer6-v0", "CheetahRun-v0", "FingerTurnEasy-v0",
                   "FishSwim-v0")
CLASSIC_STEP_ENVS, CLASSIC_STEP_STEPS = 128, 16
# phase 6m, the shared simulators: every registry name of locomotion3d and
# manipulation2d stepped as in 6l; pqn_locomotion on a quadruped and a biped
# task without evals (their 1,000-step episodes), pqn_manipulation on a task
# of each class, PegInsert-v0 (150-step episodes) with its two evals, each
# for SIM_UPDATES updates (at AC_SHORT_UPDATES, 8, the phase took 129.9 s on
# an H100 80GB HBM3 at 700 W, the Go1 run 18-31 s, PERF.md section 6)
SIM_LOCOMOTION_NAMES = (
    "Go1JoystickFlatTerrain", "Go1JoystickRoughTerrain", "Go1Getup", "Go1Handstand", "Go1Footstand",
    "SpotFlatTerrainJoystick", "SpotGetup", "SpotJoystickGaitTracking", "BarkourJoystick", "G1JoystickFlatTerrain",
    "G1JoystickRoughTerrain", "BerkeleyHumanoidJoystickFlatTerrain", "BerkeleyHumanoidJoystickRoughTerrain",
    "T1JoystickFlatTerrain", "T1JoystickRoughTerrain", "ApolloJoystickFlatTerrain", "Op3Joystick",
    "H1InplaceGaitTracking", "H1JoystickGaitTracking", "HumanoidStand", "HumanoidWalk", "HumanoidRun",
)
SIM_MANIPULATION_NAMES = (
    "PickPlace-v0", "PegInsert-v0", "BlockRotate-v0", "PandaPickCubeCartesian", "PandaPickCube",
    "PandaPickCubeOrientation", "PandaRobotiqPushCube", "AlohaHandOver", "AlohaSinglePegInsertion",
    "LeapCubeReorient", "LeapCubeRotateZAxis",
)
SIM_RUNS = (("pqn_locomotion", "Go1JoystickFlatTerrain"), ("pqn_locomotion", "HumanoidWalk"),
            ("pqn_manipulation", "PickPlace-v0"), ("pqn_manipulation", "PegInsert-v0"),
            ("pqn_manipulation", "BlockRotate-v0"), ("pqn_manipulation", "PandaPickCube"),
            ("pqn_manipulation", "PandaRobotiqPushCube"), ("pqn_manipulation", "AlohaHandOver"))
SIM_EVAL_RUNS = ("PegInsert-v0",)
# phase 6n, the network configurations: (name, alg, overrides, kind), kind
# the family whose launches and forward the run is checked by
NETWORK_UPDATES, NETWORK_CRAFTAX_UPDATES = 2, 64
NETWORK_RUNS = (
    ("minatar breakout batch_norm", "pqn_minatar", ("ENV_NAME=Breakout-MinAtar", "NORM_TYPE=batch_norm"), "ff"),
    ("minatar space_invaders batch_renorm bf16", "pqn_minatar",
     ("ENV_NAME=SpaceInvaders-MinAtar", "NORM_TYPE=batch_renorm", "BF16_COMPUTE=True"), "ff"),
    ("minatar breakout batch_norm 2 seeds", "pqn_minatar",
     ("ENV_NAME=Breakout-MinAtar", "NORM_TYPE=batch_norm", "NUM_SEEDS=2"), "ff"),
    ("craftax batch_norm bf16", "pqn_craftax", ("NORM_TYPE=batch_norm", "BF16_COMPUTE=True"), "ff"),
    ("rnn cartpole batch_norm", "pqn_rnn_cartpole", ("NORM_TYPE=batch_norm",), "rnn"),
    ("rnn craftax batch_norm (lstm, batch_renorm trunk)", "pqn_rnn_craftax", ("NORM_TYPE=batch_norm",), "rnn"),
    ("vdn spread lstm", "pqn_vdn_spread", ("RNN_CELL=lstm",), "vdn"),
    ("vdn smax batch_norm", "pqn_vdn_smax", ("NORM_TYPE=batch_norm",), "vdn"),
    ("host pong nature bf16 batch_norm (sync)", "pqn_host_minatar",
     ("ENV_NAME=Pong-EH", "CNN_TRUNK=nature", "SCORE_GAME=Pong-v5", "BF16_COMPUTE=True", "NORM_TYPE=batch_norm"),
     "host"),
    ("host pong nature bf16 batch_norm (async)", "pqn_host_minatar",
     ("ENV_NAME=Pong-EH", "CNN_TRUNK=nature", "SCORE_GAME=Pong-v5", "BF16_COMPUTE=True", "NORM_TYPE=batch_norm",
      "ASYNC_ENVS=True"), "host"),
)
SIM_UPDATES = 4
CLASSIC_FF_UPDATES, CLASSIC_FF_TEST_INTERVAL = 16, 1.0
# phase 6o, the staged API and its tooling: the stepwise CLI on pqn_cartpole
# for STEPWISE_UPDATES updates, then resumed to STEPWISE_RESUME_TO; the
# segmented trainer against one train, pqn_cartpole fused in SEG_FF segments
# of SEG_FF_UPDATES / SEG_FF updates, MemoryChain in 2 of SEG_RNN_UPDATES / 2;
# LOG_VIA_CALLBACK at LOG_INTERVAL CALLBACK_INTERVAL on each of the four
# trainers for CALLBACK_UPDATES updates; HYP_TUNE with SWEEP_TRIALS trials of
# SWEEP_UPDATES updates; with --learning-bars the segmented CartPole learning
# check of tests/test_segmented.py:36-52 at its length and config (4 segments)
STEPWISE_UPDATES, STEPWISE_CHECKPOINT_EVERY, STEPWISE_RESUME_TO = 8, 4, 12
SEG_FF_UPDATES, SEG_FF, SEG_RNN_UPDATES = 16, 4, 2
CALLBACK_UPDATES, CALLBACK_INTERVAL = 4, 2
CALLBACK_RUNS = ("pqn_cartpole", "pqn_rnn_memory_chain", "pqn_vdn_spread", "pqn_pendulum")
SWEEP_TRIALS, SWEEP_UPDATES = 2, 4
SEG_LEARNING_STEPS = 131072
# phase 6p, the sharded trainers (parallel/spmd.py): SHARDED_WORLD ranks of
# one gloo group on cuda:0, started once, run each of SHARDED_RUNS at the
# YAML's global widths, (name, alg, overrides, trainer module, updates): the
# gate run (the CartPole kernel, evals every chunk) for SHARDED_GATE_UPDATES,
# with --learning-bars tests/test_pqn_train.py::test_cartpole_learns's length,
# SHARDED_GATE_STEPS, held to its bar; the segmented pair (SHARDED_SEGMENTS
# segments against one resumable run); an nccl group of world size 1 on
# rank 0; then SHARDED_SEED_RUNS on a (2, 2) mesh of 4 ranks. The runs in
# SHARDED_SINGLE run once more in this process on the same global config
SHARDED_WORLD, SHARDED_SEGMENTS, SHARDED_TIMEOUT_S = 2, 2, 300
SHARDED_GATE_RUN, SHARDED_GATE_UPDATES, SHARDED_GATE_STEPS, SHARDED_GATE = "cartpole fused", 16, 200_000, 100.0
_NO_EVAL = "TEST_DURING_TRAINING=False"
SHARDED_RUNS = (
    ("cartpole unfused", "pqn_cartpole", ("FUSED_ROLLOUT=False", _NO_EVAL), "pqn", 4),
    ("cartpole fused", "pqn_cartpole", ("EVAL_EARLY_EXIT=False",), "pqn", SHARDED_GATE_UPDATES),
    ("breakout fused", "pqn_minatar", ("ENV_NAME=Breakout-MinAtar", _NO_EVAL), "pqn", 4),
    ("rnn cartpole", "pqn_rnn_cartpole", (_NO_EVAL,), "pqn_rnn", 2),
    ("vdn spread", "pqn_vdn_spread", (_NO_EVAL,), "pqn_vdn", 4),
    ("pendulum fused", "pqn_pendulum", (_NO_EVAL,), "pqn_ac", 4),
    ("cartpole batch_norm", "pqn_cartpole", ("NORM_TYPE=batch_norm", "NORM_INPUT=True", _NO_EVAL), "pqn", 4),
    ("segmented", "pqn_cartpole", (_NO_EVAL,), "pqn", 4),
    ("nccl", "pqn_cartpole", (_NO_EVAL,), "pqn", 4),
)
SHARDED_SEED_RUNS = (("seeds", "pqn_cartpole", (_NO_EVAL,), "pqn", 4),)
SHARDED_SINGLE = ("cartpole unfused", "cartpole fused", "breakout fused", "rnn cartpole", "vdn spread",
                  "pendulum fused", "cartpole batch_norm")
KERNELS = (
    "lambda_returns", "cartpole_rollout", "breakout_rollout", "asterix_rollout",
    "freeway_rollout", "space_invaders_rollout", "seaquest_rollout", "gru_scan_fwd",
    "gru_scan_bwd", "pendulum_ac_rollout", "eps_greedy", "lambda_returns_closure",
)
# the sources under csrc/ (a kernel's own name but for the closure form of
# the returns, which csrc/lambda_returns.cu also serves)
SOURCES = tuple(k for k in KERNELS if k != "lambda_returns_closure")
# the returns kernel, both forms: the trainers' shapes (T, E) (CartPole (64,
# 32), MinAtar (32, 128), Pendulum (32, 64); the recurrent trainer's windows,
# MemoryChain (131, 2), RNN CartPole (67, 2) and RNN Craftax (127, 256);
# VDN's targets, Spread (28, 16) and Skirmish / SMAX (67, 16)), short and
# ragged ones, many blocks through the ring, a long T of few envs
# the seeded runs' folded columns (T, S x E): CartPole with 8 and 64 seeds,
# Breakout with 4, MemoryChain and RNN CartPole with 4 seeds of B 2; the
# actor-critic trainer's at 256 envs (pqn_locomotion, pqn_manipulation, and
# pqn_reacher with 4 seeds of 64; pqn_dm_suite's 128 is above) and
# pqn_locomotion with 2 seeds; VDN Spread with 4 seeds of B 8 and
# pqn_rnn_craftax with 2 seeds of B 256 (phase 6j)
LAMBDA_SHAPES = ((64, 32), (32, 128), (32, 64), (131, 2), (67, 2), (28, 16), (67, 16), (127, 256), (127, 2),
                 (63, 2), (1, 7), (2, 33), (64, 200), (300, 4096), (1024, 3),
                 (64, 256), (64, 2048), (32, 512), (131, 8), (67, 8), (32, 256), (28, 32), (127, 512))
# where both forms are timed
LAMBDA_TIMED = ((64, 32), (32, 128), (32, 64), (131, 2), (67, 2), (28, 16), (67, 16), (127, 256), (127, 2), (63, 2),
                (64, 256), (64, 2048), (32, 512), (131, 8), (67, 8), (32, 256), (28, 32), (127, 512))
# the Breakout run and check as recorded on an H100 with the kernel's first
# CNN, one block an env (PERF.md): the last-10 mean return, the last greedy
# eval, the resets with the PRNG off. The cluster CNN sums the dense layer in
# another order, so the Q-values' last bits and with them the run may
# differ: the line is informational, the learning gate is the check
BREAKOUT_RECORD = (8.29, 9.00, 531)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_time_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def max_abs_err(got, want) -> float:
    """The largest |got - want|, a NaN against a NaN and an infinity
    against the same infinity counting 0, any other NaN or infinity inf."""
    import torch

    same = (got == want) | (got.isnan() & want.isnan())
    diff = torch.where(same, torch.zeros_like(got), (got - want).abs())
    return diff.nan_to_num(nan=float("inf"), posinf=float("inf")).max().item()


def lambda_bound_ms(T: int, E: int):
    nbytes = 4 * (E + 3 * T * E) + 4 * T * E
    return _bound(nbytes, 10 * T * E)


def rollout_bound_ms(T: int, B: int, H: int, A: int):
    weights = 4 * (4 * H + 6 * H + H * H + A * H + A)
    nbytes = weights + 4 * 5 * B + 4 * T * B * (4 + 3 + A) + 4 * 9 * B
    # per env step: two dense layers and the head (2 flops per MAC, plus
    # biases), two LayerNorms with relu (~8 per unit), physics (~40)
    per_step = 2 * 4 * H + 2 * H * H + 2 * A * H + 2 * H + A + 16 * H + 40
    return _bound(nbytes, T * B * per_step)


def minatar_bound_ms(T: int, B: int, H: int, A: int, C: int, state_ints: int, game_ops: int):
    """A MinAtar rollout kernel's bound: C observation channels (9 C conv
    taps), ``state_ints`` int32 of game state per env (read and written),
    about ``game_ops`` operations of game rules per env step."""
    taps, flat, obs = 9 * C, 1024, 100 * C
    weights = 4 * (taps * 16 + 3 * 16 + H * flat + 3 * H + A * H + A)
    state = 4 * state_ints * B
    nbytes = weights + 2 * state + 4 * T * B * (obs + 3 + A) + 4 * B * obs
    # per env step: the conv (2 flops per MAC plus bias), the dense layer and
    # the head, two LayerNorms with relu (~8 per unit), the game
    per_step = (2 * taps + 1) * flat + 8 * flat + (2 * flat + 1) * H + 8 * H + (2 * H + 1) * A + game_ops
    return _bound(nbytes, T * B * per_step)


def gru_fwd_bound_ms(T: int, B: int, H: int):
    """Reads xi, keep, h0, W_h, b_hn once and writes y, r, z, n, c; per step
    the (B, H) x (H, 3H) product and ~30 operations of gate math per unit."""
    nbytes = 4 * (T * B * 3 * H + T * B + B * H + 3 * H * H + H + 5 * T * B * H)
    return _bound(nbytes, T * (2 * B * H * 3 * H + 30 * B * H))


def gru_bwd_bound_ms(T: int, B: int, H: int):
    """Reads keep, hprev, r, z, n, c, g_y, g_hT and W_h once and writes dxi,
    dh0, dW_h and db_hn; per step the carry's (B, 3H) x (3H, H) product, the
    dW_h term (the same size) and ~20 operations per unit."""
    nbytes = 4 * (T * B + 6 * T * B * H + B * H + 3 * H * H + T * B * 3 * H + B * H + 3 * H * H + H)
    return _bound(nbytes, T * (2 * 2 * B * H * 3 * H + 20 * B * H))


def pendulum_bound_ms(T: int, B: int, H: int):
    """Reads the three MLPs' weights and the (3, B), (1, B) state once and
    writes obs, u, greedy, value, reward, done, the final obs and state; per
    env step the actor (3 -> H -> H -> 1) and two critics (4 -> H -> H -> 1),
    2 flops per MAC plus biases, two LayerNorms with relu a network (~8 per
    unit), and ~100 operations of noise, Philox and physics."""
    weights = 4 * (3 * (7 * H + H * H + 1) + 3 * H + 2 * 4 * H)
    nbytes = weights + 2 * 4 * 4 * B + 4 * T * B * 8 + 4 * 3 * B
    mlp = lambda n_in: 2 * n_in * H + 2 * H * H + 2 * H + 3 * H + 1 + 16 * H  # noqa: E731
    return _bound(nbytes, T * B * (mlp(3) + 2 * mlp(4) + 100))


def eps_greedy_bound_ms(E: int, A: int):
    """Reads the (E, A) float32 Q-matrix once and writes E int64 actions; one
    compare an element and ~100 integer operations of Philox a row."""
    return _bound(4 * E * A + 8 * E, E * A + 100 * E)


def eps_edge_rows(A: int):
    """Q-rows of every kind the argmax rule decides: -0.0 against +0.0 (each
    order), NaNs of different payloads and signs (the first wins), a NaN
    after an +inf, all -inf, all NaN, and +inf tied with itself."""
    import numpy as np

    nan = lambda bits: np.array([bits], np.uint32).view(np.float32)[0]  # noqa: E731
    payloads = [nan(0x7FC00000), nan(0x7F800001), nan(0xFFC00000), nan(0x7FFFFFFF)]
    rows = []
    base = -np.ones(A, np.float32)
    for order in ((0.0, -0.0), (-0.0, 0.0)):
        r = base.copy()
        r[[A // 3, A - 1]] = order
        rows.append(r)
    for i, p in enumerate(payloads):
        r = base.copy()
        r[(A // 2 + i) % A] = p
        r[(A // 2 + i + 1) % A] = payloads[(i + 1) % 4]
        rows.append(r)
    r = base.copy()
    r[0], r[A - 1] = np.inf, payloads[2]
    rows.append(r)
    rows.append(np.full(A, -np.inf, np.float32))
    rows.append(np.full(A, payloads[1], np.float32))
    r = base.copy()
    r[[A - 1, A // 2]] = np.inf
    rows.append(r)
    return np.stack(rows)


def kernel_resources(log_text: str):
    """{mangled kernel name: (registers, spill store bytes)} from nvcc's
    -Xptxas -v output."""
    import re

    out, name = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            out[name] = [None, int(m.group(1))]
        m = re.search(r"Used (\d+) registers", line)
        if m and name in out:
            out[name][0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def named_instance(resources, key: str):
    """(registers, spill bytes) of the kernel whose mangled name holds key."""
    hits = [v for k, v in resources.items() if key in k]
    return hits[0] if hits else (None, None)


def gru_instance(resources, kernel: str, *template_args: int):
    """(registers, spill bytes) of one template instance of a GRU scan kernel:
    R, then the bools (slice in shared memory, slice in registers)."""
    key = f"{kernel}ILi{template_args[0]}E" + "".join(f"Lb{int(a)}E" for a in template_args[1:]) + "E"
    return named_instance(resources, key)


def craftax_bar_metric(metrics):
    """The metric a Craftax learning bar would read: the mean of the done-masked
    returned_episode_returns over the last 10 % of updates, counting only the
    updates in which an episode ended (a done-masked mean is 0 where none
    did), and that count."""
    n = len(metrics["returned_episode_returns"])
    returns = metrics["returned_episode_returns"][n - n // 10:]
    ended = metrics["returned_episode"][n - n // 10:] > 0
    return float(returns[ended].mean()), int(ended.sum())


def pendulum_inputs(B: int, H: int, seed: int, dev):
    """The kernel's weights from a seeded actor and two-critic ensemble, and
    states with theta in [-pi, pi), theta_dot in [-8, 8] and times in [0, 200)."""
    import numpy as np
    import torch

    from purejaxql_torch.models.actor_critic import Actor, CriticEnsemble
    from purejaxql_torch.ops.pendulum_rollout import pendulum_ac_weights

    gen = torch.Generator().manual_seed(seed)
    actor = Actor(3, 1, 2.0, 0.0, [H, H], generator=gen).to(dev)
    critics = CriticEnsemble(2, 3, 1, [H, H], generator=gen).to(dev)
    r = np.random.RandomState(seed)
    stf = np.stack([r.uniform(-np.pi, np.pi, B), r.uniform(-8, 8, B), np.zeros(B)]).astype(np.float32)
    sti = r.randint(0, 200, (1, B)).astype(np.int32)
    return pendulum_ac_weights(actor, critics), torch.tensor(stf, device=dev), torch.tensor(sti, device=dev)


def seeded_gru_inputs(T: int, S: int, B: int, H: int, seed: int, dev):
    """S seeds' GRU scan inputs (``gru_inputs`` each), seed-major: xi (T,
    S B, 3H), keep, h0 (S B, H), W_h (S, H, 3H), b_hn (S, H), g_y, g_hT;
    and each seed's own."""
    import torch

    lanes = [gru_inputs(T, B, H, seed + 100 * s, dev) for s in range(S)]
    dims = (1, 1, 0, None, None, 1, 0)
    return [torch.stack(xs) if d is None else torch.cat(xs, d) for d, xs in zip(dims, zip(*lanes))], lanes


def gru_inputs(T: int, B: int, H: int, seed: int, dev):
    """The GRU scan's inputs from numpy: xi ~ N(0, 1), keep with about 20 %
    resets, h0 ~ N(0, 0.25), an orthogonal W_h (the init's scale), b_hn ~
    N(0, 0.01), and random cotangents g_y, g_hT."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    q, _ = np.linalg.qr(rng.randn(3 * H, 3 * H))
    arrays = (
        rng.randn(T, B, 3 * H), rng.rand(T, B, 1) > 0.2, 0.5 * rng.randn(B, H),
        q[:H], 0.1 * rng.randn(H), rng.randn(T, B, H), rng.randn(B, H),
    )
    return [torch.tensor(np.asarray(a, np.float32), device=dev) for a in arrays]


# per game: (channels, state ints per env, game operations per env step):
# Breakout's (8, B) matrix and brick map, Asterix's (48, B), Freeway's
# (32, B), SpaceInvaders' (16, B) and three maps, Seaquest's (128, B);
# SpaceInvaders' rules touch every cell a few times, the others' a few slots
# or lanes. Seaquest's, counted from csrc/seaquest_rollout.cu: its 1,000
# plane cells written once and its 28 pool entities added onto them with a
# clamp (~1,100), the rules over the five pools (hits 12 x 4 pairs ~400,
# moves, shots, spawns, collisions ~500): about 2,000
GAME_SHAPES = {
    "breakout_rollout": (4, 8 + 100, 50),
    "asterix_rollout": (4, 48, 100),
    "freeway_rollout": (7, 32, 100),
    "space_invaders_rollout": (6, 16 + 300, 1000),
    "seaquest_rollout": (10, 128, 2000),
}


def train(cli, compose, alg: str, steps: int, save_path: str, counters, extra=(),
          policy=("FUSED_ROLLOUT", "EVAL_EARLY_EXIT")):
    """One full-width run through the CLI's entry point, with every launch
    counter zeroed just before it and read just after it; the flags in
    ``policy`` must have been turned on by the config's cuda policy (a flag
    name for True, or a (flag, value) pair). Returns (outputs, seconds,
    launches by kernel)."""
    import torch

    jsonl = os.path.join(save_path, "train.jsonl")
    if os.path.exists(jsonl):
        os.remove(jsonl)
    config = compose(
        alg=alg,
        overrides=[
            f"TOTAL_TIMESTEPS={steps}", f"TOTAL_TIMESTEPS_DECAY={steps}",
            f"SAVE_PATH={save_path}", f"LOG_JSONL={jsonl}", *extra,
        ],
    )
    expected = [flag if isinstance(flag, tuple) else (flag, True) for flag in policy]
    check(all(config.get(k) == v and type(config.get(k)) is type(v) for k, v in expected),
          f"{alg}: the cuda policy did not turn on {policy}")
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = cli.single_run(config)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return outs, wall, {name: fn.launches for name, fn in counters.items()}


def check_run(name, outs, wall, launches, n_updates, steps_per_update, rollout, gate):
    """The checks every training run shares: one lambda-returns launch per
    update, the game's rollout kernel more than once per update (the eval
    chunks) and no other rollout kernel, the env-step count, finite metrics
    and, where ``gate`` is given, learning. Returns (mean of the last 10
    returned_episode_returns, last greedy eval return)."""
    import numpy as np

    train_state = outs["runner_state"][0]
    m = {k: v.cpu().numpy() for k, v in outs["metrics"].items()}
    last10 = float(m["returned_episode_returns"][-10:].mean())
    last_eval = float(m["test/returned_episode_returns"][-1])
    print(
        f"train {name}: {train_state.timesteps} env steps in {wall:.2f} s wall "
        f"({train_state.timesteps / wall:.0f} env-steps/s, eval included); launches {launches}; "
        f"mean of last 10 returned_episode_returns {last10:.2f}; "
        f"last greedy eval return {last_eval:.2f}"
    )
    check(all(p.device.type == "cuda" for p in train_state.network.parameters()), f"{name}: a parameter is not on cuda")
    check(launches["lambda_returns"] == n_updates,
          f"{name}: lambda_returns launched {launches['lambda_returns']} times, expected {n_updates}")
    check(launches[rollout] > n_updates, f"{name}: {rollout} launched {launches[rollout]} times: no eval chunks")
    others = {k: v for k, v in launches.items() if k not in ("lambda_returns", rollout) and v}
    check(not others, f"{name}: another game's kernel launched: {others}")
    check(train_state.timesteps == n_updates * steps_per_update, f"{name}: wrong env-step count")
    check(all(np.isfinite(m[k]).all() for k in ("td_loss", "qvals", "returned_episode_returns")),
          f"{name}: non-finite metrics")
    check(np.isfinite(last_eval), f"{name}: the last greedy eval finished no episode")
    if gate is not None:
        check(last10 > gate, f"{name} did not learn: mean of last 10 returned_episode_returns {last10} <= {gate}")
    return last10, last_eval


def asterix_states(B: int, seed: int):
    """Asterix states that meet every rule: half at an episode's start, half
    on random boards (entities in any slot, timers about to fire, ramps due
    at both parities, times near the limit), a quarter of those with enemies
    next to the player on its row and the rows above and below."""
    import numpy as np
    import torch

    from purejaxql_torch.envs.minatar.asterix import AsterixParams, AsterixState, start_state
    from purejaxql_torch.ops.asterix_rollout import state_matrix_from_asterix

    r = np.random.RandomState(seed)
    n = B - B // 2
    cols = {
        "player_x": r.randint(0, 10, n), "player_y": r.randint(1, 9, n),
        "e_exists": r.rand(n, 8) < 0.5, "e_x": r.randint(0, 10, (n, 8)),
        "e_lr": r.rand(n, 8) < 0.5, "e_gold": r.rand(n, 8) < 0.3,
        "spawn_speed": r.randint(1, 11, n), "spawn_timer": r.randint(0, 3, n),
        "move_speed": r.randint(1, 6, n), "move_timer": r.randint(0, 3, n),
        "ramp_timer": r.choice([0, 1, 50], n), "ramp_index": r.randint(0, 6, n),
        "terminal": np.zeros(n, bool), "time": r.randint(0, 1000, n),
    }
    q = n // 4
    cols["player_x"][:q], cols["player_y"][:q], cols["move_timer"][:q] = 5, 5, 0
    for slot in (3, 4, 5):
        cols["e_exists"][:q, slot], cols["e_gold"][:q, slot] = True, False
        cols["e_lr"][:q, slot] = np.arange(q) % 2 == 0
        cols["e_x"][:q, slot] = np.where(cols["e_lr"][:q, slot], 4, 6)
    rand = AsterixState(**{k: torch.tensor(v if v.dtype == bool else v.astype(np.int32)) for k, v in cols.items()})
    st = torch.cat([state_matrix_from_asterix(start_state(B // 2, AsterixParams(), "cpu")),
                    state_matrix_from_asterix(rand)], 1)
    return (st.contiguous(),)


def freeway_states(B: int, seed: int):
    """Freeway states that meet every rule: half at an episode's start, half
    on random roads (the chicken anywhere, cooldowns running, timers about
    to fire, both directions), a quarter of those 0-31 steps before the
    2500-step limit."""
    import numpy as np
    import torch

    from purejaxql_torch.envs.minatar.freeway import FreewayDraws, FreewayState, start_state
    from purejaxql_torch.ops.freeway_rollout import state_matrix_from_freeway

    r = np.random.RandomState(seed)
    h, n = B // 2, B - B // 2
    i32 = lambda a: torch.tensor(np.asarray(a, np.int32))  # noqa: E731
    starts = start_state(i32(r.randint(0, 10, (h, 8))), FreewayDraws(
        i32(r.randint(1, 6, (h, 8))), i32(r.choice([-1, 1], (h, 8)))))
    time = r.randint(0, 2400, n)
    time[: n // 4] = 2499 - np.arange(n // 4) % 32
    rand = FreewayState(
        pos=i32(r.randint(0, 10, n)), car_x=i32(r.randint(0, 10, (n, 8))),
        car_timer=i32(r.randint(0, 4, (n, 8))),
        car_speed=i32(r.randint(1, 6, (n, 8)) * r.choice([-1, 1], (n, 8))),
        move_timer=i32(r.randint(0, 4, n)), terminal=torch.zeros(n, dtype=torch.bool), time=i32(time),
    )
    st = torch.cat([state_matrix_from_freeway(starts), state_matrix_from_freeway(rand)], 1)
    return (st.contiguous(),)


def space_invaders_states(B: int, seed: int):
    """SpaceInvaders states that meet every rule: half at an episode's
    start, half on random boards (thinned waves anywhere, at the walls and on
    the bottom row, bullets in flight both ways, timers about to fire), a
    quarter of those with a row of enemy bullets over the cannon's row."""
    import numpy as np
    import torch

    from purejaxql_torch.envs.minatar.space_invaders import (
        SpaceInvadersParams,
        SpaceInvadersState,
        start_state,
    )
    from purejaxql_torch.ops.space_invaders_rollout import state_matrix_from_space_invaders

    r = np.random.RandomState(seed)
    n = B - B // 2
    alien = np.zeros((n, 10, 10), np.int32)
    for i in range(n):
        top, left = r.randint(0, 7), r.randint(0, 5)
        alien[i, top : top + 4, left : left + 6] = r.rand(4, 6) < 0.6
    ebul = (r.rand(n, 10, 10) < 0.05).astype(np.int32)
    ebul[: n // 4, 8, :] = 1
    i32 = lambda a: torch.tensor(np.asarray(a, np.int32))  # noqa: E731
    rand = SpaceInvadersState(
        pos=i32(r.randint(0, 10, n)), f_bullet_map=i32(r.rand(n, 10, 10) < 0.05), e_bullet_map=i32(ebul),
        alien_map=i32(alien), alien_dir=i32(r.choice([-1, 1], n)),
        enemy_move_interval=i32(r.randint(6, 13, n)), alien_move_timer=i32(r.randint(0, 3, n)),
        alien_shot_timer=i32(r.randint(0, 3, n)), ramp_index=i32(r.randint(0, 4, n)),
        shot_timer=i32(r.randint(0, 3, n)), terminal=torch.zeros(n, dtype=torch.bool),
        time=i32(r.randint(0, 1000, n)),
    )
    a = state_matrix_from_space_invaders(start_state(B // 2, SpaceInvadersParams(), "cpu"))
    b = state_matrix_from_space_invaders(rand)
    return tuple(torch.cat([x, y], -1).contiguous() for x, y in zip(a, b))


def seaquest_states(B: int, seed: int):
    """Seaquest states that meet every rule: half at an episode's start,
    half on random boards (the sub anywhere, either way round, oxygen from
    empty to full, 0-6 divers on board, every pool thinly filled with its
    timers about to fire, subs about to shoot, spawns and surfacing due,
    times near the limit)."""
    import numpy as np
    import torch

    from purejaxql_torch.envs.minatar.seaquest import SeaquestParams, SeaquestState, start_state
    from purejaxql_torch.ops.seaquest_rollout import state_matrix_from_seaquest

    r = np.random.RandomState(seed)
    n = B - B // 2
    cols = {
        "sub_x": r.randint(0, 10, n), "sub_y": r.choice([0, 0, 1, 2, 4, 8], n), "sub_or": r.randint(0, 2, n),
        "oxygen": r.choice([0, 1, 2, 57, 199, 200], n), "divers": r.randint(0, 7, n),
        "shot_timer": r.randint(0, 3, n), "spawn_timer": r.randint(0, 3, n),
        "diver_spawn_timer": r.randint(0, 3, n), "move_interval": r.randint(1, 6, n),
        "surfaced": r.rand(n) < 0.5, "terminal": np.zeros(n, bool), "time": r.randint(0, 1000, n),
    }
    for p, k in (("f", 8), ("s", 4), ("fb", 4), ("eb", 4), ("d", 4)):
        cols[f"{p}_exists"] = r.rand(n, k) < 0.4
        cols[f"{p}_x"] = r.randint(0, 10, (n, k))
        cols[f"{p}_y"] = r.randint(0, 9, (n, k)) if p in ("fb", "eb") else r.randint(1, 9, (n, k))
        cols[f"{p}_dir"] = r.choice([-1, 1], (n, k))
        if p in ("f", "s", "d"):
            cols[f"{p}_timer"] = r.randint(0, 3, (n, k))
    cols["s_shot_timer"] = r.randint(0, 4, (n, 4))
    rand = SeaquestState(**{k: torch.tensor(v if v.dtype == bool else v.astype(np.int32)) for k, v in cols.items()})
    st = torch.cat([state_matrix_from_seaquest(start_state(B // 2, SeaquestParams(), "cpu")),
                    state_matrix_from_seaquest(rand)], 1)
    return (st.contiguous(),)


def compare_minatar(name, kernel, plain, weights, states, T, use_prng, seed=77, eps=0.1, **kw):
    """One kernel call against its twin on the same inputs: every output
    equal but Q, within 1e-4. Returns (max |Q error|, resets, reward sum,
    non-greedy actions, rewards that are not whole: Seaquest's cash-ins)."""
    import torch

    got = kernel(seed, eps, weights, *states, T, use_prng=use_prng, **kw)
    want = plain(seed, eps, weights, *states, T, use_prng=use_prng, **kw)
    torch.cuda.synchronize()
    mism = (got[1] != want[1]).nonzero()
    if len(mism):
        t, b = mism[0].tolist()
        top2 = want[4][t, b].topk(2).values
        fail(
            f"{name} prng={use_prng}: action differs first at t={t} env={b}; "
            f"plain q-gap there {(top2[0] - top2[1]).item():.3g}, kernel q {got[4][t, b].tolist()} "
            f"plain q {want[4][t, b].tolist()}"
        )
    labels = ("obs", "act", "rew", "done", "q", "final_obs") + tuple(f"state{i}" for i in range(len(states)))
    for label, g, w in zip(labels, got, want):
        if label != "q":
            check(torch.equal(g, w), f"{name} prng={use_prng}: {label} differs")
    err = (got[4] - want[4]).abs().max().item()
    check(err <= 1e-4, f"{name} prng={use_prng}: q err {err} > 1e-4")
    n_done, rew = int(want[3].sum()), float(want[2].sum())
    n_random = int((want[1].long() != want[4].argmax(-1)).sum())
    return err, n_done, rew, n_random, int((want[2] != want[2].floor()).sum())


def start_gate_seed_workers(root: str, log_dir: str):
    """Start the AC gates' seeds past 0 in worker processes, one a seed
    index k (scripts/ac_learning_bar.py --seeds k --report: each run of
    AC_GATE_SEEDS that has a seed k, at its gate's length). Each runs on one
    CPU thread (OMP_NUM_THREADS=1), so that the workers share the host's
    cores; the orthogonal init's QR rounds otherwise on one thread than on
    several, so a worker's seed k starts from other weights than seed k of
    a CLI run. Every worker is killed when this process exits. Returns
    [(process, log, runs, k)]."""
    import atexit

    os.makedirs(log_dir, exist_ok=True)
    workers = []
    for k in range(1, max(AC_GATE_SEEDS.values())):
        runs = [run for run, n in AC_GATE_SEEDS.items() if k < n]
        log = os.path.join(log_dir, f"seed{k}.log")
        with open(log, "w") as f:
            proc = subprocess.Popen(
                [sys.executable, os.path.join(root, "scripts", "ac_learning_bar.py"),
                 "--runs", *runs, "--seeds", str(k), "--report"],
                stdout=f, stderr=subprocess.STDOUT, cwd=root, env={**os.environ, "OMP_NUM_THREADS": "1"},
            )
        workers.append((proc, log, runs, k))
    atexit.register(lambda: [p.kill() for p, *_ in workers if p.poll() is None])
    return workers


def gate_seed_results(workers, deadline: float):
    """Wait for the workers until ``deadline`` (perf_counter seconds) and
    read their JSON lines. Fails if a worker runs past it, exits non-zero
    or misses a run. Returns {(run, seed): line}."""
    results = {}
    for proc, log, runs, k in workers:
        try:
            rc = proc.wait(timeout=max(1.0, deadline - time.perf_counter()))
        except subprocess.TimeoutExpired:
            fail(f"the gate seeds' worker {k} ({runs}) ran past {AC_GATE_TIMEOUT_S} s")
        with open(log) as f:
            text = f.read()
        check(rc == 0, f"the gate seeds' worker {k} exited {rc}:\n{text[-3000:]}")
        for line in text.splitlines():
            if line.startswith("{"):
                d = json.loads(line)
                results[(d["run"], d["seed"])] = d
        check(all((run, k) in results for run in runs), f"the gate seeds' worker {k} missed a run:\n{text[-3000:]}")
    return results


def seeded_families(cli, compose, load_params, wrappers, counters, save_path, card, craftax_one_seed, bars):
    """Phase 6j: the families beyond FF and the recurrent trainer with
    NUM_SEEDS as one program, each through the CLI's entry point with the
    launch counters zeroed just before and read just after, each lane's
    numbers and the aggregate rate (seeds x one seed's env steps over the
    wall) printed. ``craftax_one_seed`` is phase 6f's one-seed run of the
    same length, whose rate and launches the 4 seeds' are set beside. With
    ``bars`` the VDN and Reacher runs train for their bars' lengths and are
    held to them, else for GATE_SHORT_UPDATES updates. Returns {run:
    launches} and the lanes' gate numbers."""
    import numpy as np
    import torch

    launches_by_run, gates = {}, {}

    def metrics_of(name, outs, seeds, n_updates):
        m = {k: v.cpu().numpy() for k, v in outs["metrics"].items()}
        check(all(v.shape == (seeds, n_updates) for v in m.values()),
              f"{name}: metrics not ({seeds}, {n_updates}): { {k: v.shape for k, v in m.items()} }")
        return m

    def only(name, launches, expected):
        for k, n in expected.items():
            check(launches[k] == n, f"{name}: {k} launched {launches[k]} times, expected {n} (one seed's count)")
        others = {k: v for k, v in launches.items() if k not in expected and v}
        check(not others, f"{name}: another kernel launched: {others}")

    def lanes_apart(name, modules, seeds, lead=1):
        """Every parameter on the card with the seeds leading (``lead``
        members a seed), and lane 0's first weight unlike lane 1's."""
        params = [p for mod in modules for p in mod.parameters()]
        check(all(p.device.type == "cuda" and p.shape[0] == seeds * lead for p in params[:1] + params[-1:]),
              f"{name}: a parameter is not on cuda or has no seed axis")
        w = next(p for p in modules[0].parameters() if p.dim() >= 3)  # a stacked Dense or conv weight
        check(not torch.equal(w[0], w[lead]), f"{name}: the lanes' params are equal")

    # ---- (a) pqn_craftax, 4 seeds, the fast program ----
    ccfg = compose(alg="pqn_craftax")
    S, steps = SEED_CRAFTAX, CRAFTAX_STEPS
    updates = steps // ccfg["NUM_STEPS"] // ccfg["NUM_ENVS"]
    wrappers.BankedResetVecEnv.refreshes = 0
    outs, wall, launches = train(cli, compose, "pqn_craftax", steps, save_path, counters,
                                 extra=[f"NUM_SEEDS={S}"], policy=CRAFTAX_FAST_POLICY)
    bursts = wrappers.BankedResetVecEnv.refreshes
    ts = outs["runner_state"][0]
    m = metrics_of("craftax seeds", outs, S, updates)
    only("craftax seeds", launches, {"eps_greedy": updates})
    check(launches["eps_greedy"] == craftax_one_seed["launches"]["eps_greedy"],
          f"craftax seeds: {launches['eps_greedy']} eps_greedy launches, one seed's run "
          f"{craftax_one_seed['launches']['eps_greedy']}")
    check(bursts == -(-updates // 16), f"craftax seeds: {bursts} refresh bursts, expected {-(-updates // 16)}")
    env_state = outs["runner_state"][1][1]
    check(isinstance(env_state, wrappers.BankedResetState) and env_state.bank_w32.shape[0] == S * 256,
          "craftax seeds: the training env is not S banks of 256")
    check(ts.network.BatchRenorm_0.steps.tolist() == [updates] * S,
          f"craftax seeds: the input norms stepped {ts.network.BatchRenorm_0.steps.tolist()}, expected {updates} each")
    check(all(np.isfinite(m[k]).all() for k in ("td_loss", "qvals")), "craftax seeds: non-finite td_loss or qvals")
    check(len({tuple(r) for r in m["td_loss"].tolist()}) == S, "craftax seeds: two lanes have the same losses")
    lanes_apart("craftax seeds", [ts.network], S)
    lane_bar = [craftax_bar_metric({k: v[i] for k, v in m.items()}) for i in range(S)]
    rate = S * ts.timesteps / wall
    one_rate = craftax_one_seed["env_steps_per_s"]
    print(f"train craftax, {S} seeds as one program (the fast program): {S} x {ts.timesteps} env steps in "
          f"{wall:.2f} s wall ({rate:.0f} env-steps/s aggregate; one seed of the same length "
          f"{one_rate:.0f}); launches {launches}; refresh bursts {bursts}; "
          f"each lane's done-masked return over the last 10 % {[round(b[0], 4) for b in lane_bar]} "
          f"({[b[1] for b in lane_bar]} updates with an end), last td_loss {m['td_loss'][:, -1].tolist()}")
    check(all(os.path.exists(os.path.join(save_path, "Craftax-Symbolic-v1",
                                          f"pqn_craftax_Craftax-Symbolic-v1_seed0_vmap{i}.safetensors"))
              for i in range(S)), "craftax seeds: a per-seed checkpoint is missing")
    print(json.dumps({"seeds_craftax_run": {
        "seeds": S, "env_steps_per_s": rate, "one_seed_env_steps_per_s": one_rate, "wall_s": wall,
        "bar_metric_by_seed": [b[0] for b in lane_bar], "refresh_bursts": bursts, "launches": launches,
        "card": card}}))
    launches_by_run["craftax"] = launches

    # 16 updates with BF16_COMPUTE: each lane's trunk in bfloat16 over float32
    # parameters, its forward held within BF16_BOUND of float32's
    bsteps = SEED_CRAFTAX_BF16_UPDATES * ccfg["NUM_ENVS"]
    outs, wall, launches = train(cli, compose, "pqn_craftax", bsteps, save_path, counters,
                                 extra=[f"NUM_SEEDS={S}", "BF16_COMPUTE=True"], policy=CRAFTAX_FAST_POLICY)
    net = outs["runner_state"][0].network
    m = metrics_of("craftax seeds bf16", outs, S, SEED_CRAFTAX_BF16_UPDATES)
    only("craftax seeds bf16", launches, {"eps_greedy": SEED_CRAFTAX_BF16_UPDATES})
    check(all(np.isfinite(m[k]).all() for k in ("td_loss", "qvals")), "craftax seeds bf16: non-finite metrics")
    obs = outs["runner_state"][1][0]
    with torch.no_grad():
        q_bf16 = net(obs, train=False)
        f32_net = copy.deepcopy(net)
        f32_net.dtype = torch.float32
        q_f32 = f32_net(obs, train=False)
    errs = (q_bf16 - q_f32).abs().reshape(S, -1).amax(1)
    scales = q_f32.abs().reshape(S, -1).amax(1)
    check(net.dtype == torch.bfloat16 and q_bf16.dtype == torch.float32
          and all(p.dtype == torch.float32 for p in net.parameters()), "craftax seeds bf16: the dtypes are wrong")
    print(f"train craftax, {S} seeds, BF16_COMPUTE: {S} x {outs['runner_state'][0].timesteps} env steps in "
          f"{wall:.2f} s wall ({S * outs['runner_state'][0].timesteps / wall:.0f} env-steps/s aggregate); launches "
          f"{launches}; each lane's bfloat16 forward against float32 on its weights: max |diff| "
          f"{[round(float(e), 5) for e in errs]}, max |Q| {[round(float(x), 4) for x in scales]}")
    check(bool((errs <= BF16_BOUND * scales).all()), f"craftax seeds bf16: a lane's forward is off float32: {errs}")

    # ---- (b) pqn_rnn_craftax, 2 seeds, 3 updates of the fast program ----
    rcfg = compose(alg="pqn_rnn_craftax")
    S = SEED_RNN_CRAFTAX
    r_updates = RNN_CRAFTAX_STEPS // rcfg["NUM_STEPS"] // rcfg["NUM_ENVS"]
    r_grad = r_updates * rcfg["NUM_EPOCHS"] * rcfg["NUM_MINIBATCHES"]
    outs, wall, launches = train(
        cli, compose, "pqn_rnn_craftax", RNN_CRAFTAX_STEPS, save_path, counters,
        extra=["TOTAL_TIMESTEPS_DECAY=1e9", f"NUM_SEEDS={S}"],
        policy=("FAST_BPTT", ("EXPLORATION_KERNEL", "pallas"), ("RESET_BANK", 256)),
    )
    ts = outs["runner_state"][0]
    m = metrics_of("rnn craftax seeds", outs, S, r_updates)
    only("rnn craftax seeds", launches, {
        "eps_greedy": rcfg["MEMORY_WINDOW"] + rcfg["NUM_STEPS"] + r_updates * rcfg["NUM_STEPS"],
        "lambda_returns_closure": r_grad})
    check(ts.network.BatchRenorm_0.steps.tolist() == [r_grad] * S,
          f"rnn craftax seeds: the input norms stepped {ts.network.BatchRenorm_0.steps.tolist()}")
    check(isinstance(outs["runner_state"][2][4], wrappers.BankedResetState), "rnn craftax seeds: not banked")
    check(all(np.isfinite(v).all() for v in m.values()), "rnn craftax seeds: non-finite metrics")
    check(not np.array_equal(m["td_loss"][0], m["td_loss"][1]), "rnn craftax seeds: the lanes' losses are equal")
    lanes_apart("rnn craftax seeds", [ts.network], S)
    rate = S * ts.timesteps / wall
    print(f"train rnn craftax, {S} seeds as one program (LSTM H 512, the fast program): {S} x {ts.timesteps} env "
          f"steps in {wall:.2f} s wall ({rate:.0f} env-steps/s aggregate); launches {launches}; td_loss by lane "
          f"{m['td_loss'].round(5).tolist()}")
    print(json.dumps({"seeds_rnn_craftax_run": {"seeds": S, "env_steps_per_s": rate, "wall_s": wall,
                                                "launches": launches, "card": card}}))
    launches_by_run["rnn_craftax"] = launches

    # ---- (c) pqn_vdn_spread, 4 seeds, at the JAX bar's settings ----
    S = SEED_VDN
    vcfg = compose(alg="pqn_vdn_spread", overrides=list(SEED_VDN_EXTRA))
    steps = SEED_VDN_STEPS if bars else GATE_SHORT_UPDATES * vcfg["NUM_STEPS"] * vcfg["NUM_ENVS"]
    v_updates = steps // vcfg["NUM_STEPS"] // vcfg["NUM_ENVS"]
    v_grad = v_updates * vcfg["NUM_EPOCHS"] * vcfg["NUM_MINIBATCHES"]
    outs, wall, launches = train(cli, compose, "pqn_vdn_spread", steps, save_path, counters,
                                 extra=[f"NUM_SEEDS={S}", *SEED_VDN_EXTRA], policy=("FAST_BPTT", "PALLAS_BPTT"))
    ts = outs["runner_state"][0]
    m = metrics_of("spread seeds", outs, S, v_updates)
    # the GRU kernels and the closure returns once a grad step, as one seed's run
    only("spread seeds", launches, {k: v_grad for k in ("gru_scan_fwd", "gru_scan_bwd", "lambda_returns_closure")})
    check(all(np.isfinite(m[k]).all() for k in ("td_loss", "qvals", "returned_episode_returns")),
          "spread seeds: non-finite metrics")
    lanes_apart("spread seeds", [ts.network], S)
    rets = m["returned_episode_returns"]
    tenth = max(1, v_updates // 10)
    early, late = rets[:, :tenth].mean(1), rets[:, -tenth:].mean(1)
    passed = int((late > early + VDN_SPREAD_GATE).sum())
    rate = S * ts.timesteps / wall
    print(f"train spread (pqn_vdn), {S} seeds as one program: {S} x {ts.timesteps} env steps in {wall:.2f} s wall "
          f"({rate:.0f} env-steps/s aggregate); launches {launches}; each lane's first / last tenth team return "
          f"{[(round(float(a), 3), round(float(b), 3)) for a, b in zip(early, late)]}; {passed} of {S} lanes past "
          f"first + {VDN_SPREAD_GATE} (gate: {SEED_VDN_PASS})")
    check(not bars or passed >= SEED_VDN_PASS,
          f"the seeded VDN trainer did not learn Spread: {passed} of {S} lanes past the bar")
    for i in range(S):
        saved = load_params(os.path.join(save_path, "Spread-v0", f"pqn_vdn_rnn_Spread-v0_seed0_vmap{i}.safetensors"))
        check(torch.equal(saved["ScannedRNN_0"]["GRUCell_0"]["hn"]["kernel"],
                          ts.network.ScannedRNN_0.GRUCell_0.hn.weight[i].T.cpu()),
              f"spread seeds: the checkpoint of seed {i} is not lane {i}")
    print(json.dumps({"seeds_vdn_spread_run": {
        "seeds": S, "env_steps_per_s": rate, "wall_s": wall, "early_tenth_by_seed": early.tolist(),
        "late_tenth_by_seed": late.tolist(), "passed": passed, "gate": [VDN_SPREAD_GATE, SEED_VDN_PASS],
        "launches": launches, "card": card}}))
    launches_by_run["vdn"] = launches
    gates["vdn_spread"] = passed

    # ---- (d) the actor-critic trainer: pqn_reacher with 4 seeds, pqn_locomotion with 2 ----
    def ac_seeded(alg, seeds, steps, extra=()):
        cfg = compose(alg=alg, overrides=list(extra))
        E, T = cfg["NUM_ENVS"], cfg["NUM_STEPS"]
        n_updates = steps // (E * T)
        outs, wall, launches = train(cli, compose, alg, steps, save_path, counters,
                                     extra=[f"NUM_SEEDS={seeds}", *extra], policy=())
        ts = outs["runner_state"][0]
        m = metrics_of(f"{alg} seeds", outs, seeds, n_updates)
        only(f"{alg} seeds", launches, {"lambda_returns": n_updates})
        check(all(np.isfinite(v).all() for v in m.values()), f"{alg} seeds: non-finite metrics")
        check(ts["actor"].timesteps == n_updates * E * T, f"{alg} seeds: wrong env-step count")
        lanes_apart(f"{alg} seeds (actor)", [ts["actor"].network], seeds)
        lanes_apart(f"{alg} seeds (critics)", [ts["critic"].network], seeds, cfg.get("NUM_CRITICS", 2))
        check(not np.array_equal(m["value_loss"][0], m["value_loss"][1]), f"{alg} seeds: the lanes' losses are equal")
        return outs, wall, launches, m, cfg

    S = SEED_REACHER
    rcfg = compose(alg="pqn_reacher")
    # the short run evals every quarter (the YAML's 10 % would eval after every update)
    outs, wall, launches, m, cfg = ac_seeded(
        "pqn_reacher", S, REACHER_STEPS if bars else GATE_SHORT_UPDATES * rcfg["NUM_STEPS"] * rcfg["NUM_ENVS"],
        extra=() if bars else ("TEST_INTERVAL=0.25",))
    evals = m["test/returned_episode_returns"]
    bests = evals.max(1)
    rate = S * outs["runner_state"][0]["actor"].timesteps / wall
    interval = max(1, int(evals.shape[1] * cfg["TEST_INTERVAL"]))
    print(f"train reacher (pqn_ac), {S} seeds as one program: {S} x {outs['runner_state'][0]['actor'].timesteps} env "
          f"steps in {wall:.2f} s wall ({rate:.0f} env-steps/s aggregate, eval included); launches {launches}; each "
          f"lane's greedy evals {[[round(float(v), 1) for v in row[interval - 1 :: interval]] for row in evals]}; "
          f"best by lane {[round(float(b), 1) for b in bests]}; gate: the best over the lanes > {REACHER_GATE}")
    print(json.dumps({"reacher_gate_seeds": {
        "best_evals": bests.tolist(), "passed": int((bests > REACHER_GATE).sum()), "seeds": S, "gate": REACHER_GATE,
        "best": float(bests.max()), "env_steps_per_s": rate, "wall_s": wall, "launches": launches, "card": card}}))
    check(not bars or float(bests.max()) > REACHER_GATE,
          f"the actor-critic trainer did not learn Reacher in any of {S} lanes: best evals {bests.tolist()}")
    launches_by_run["reacher"] = launches
    gates["reacher"] = float(bests.max())

    S = SEED_LOCOMOTION
    lcfg = compose(alg="pqn_locomotion")
    steps = AC_SHORT_UPDATES * lcfg["NUM_STEPS"] * lcfg["NUM_ENVS"]
    outs, wall, launches, m, cfg = ac_seeded("pqn_locomotion", S, steps,
                                             extra=(f"TEST_INTERVAL={AC_SHORT_TEST_INTERVAL}",))
    env_state = outs["runner_state"][1][1]
    E, obs_dim = cfg["NUM_ENVS"], env_state.mean.shape[-1]
    count = np.float32(np.float32(1e-4) + np.float32(E))
    for _ in range(AC_SHORT_UPDATES * cfg["NUM_STEPS"]):
        count = np.float32(count + np.float32(E))
    check(tuple(env_state.mean.shape) == (S, obs_dim) and tuple(env_state.count.shape) == (S,)
          and env_state.count.tolist() == [float(count)] * S,
          f"locomotion seeds: observation statistics {tuple(env_state.mean.shape)}, counts "
          f"{env_state.count.tolist()}, expected ({S}, {obs_dim}) and {float(count)} each")
    check(not torch.equal(env_state.mean[0], env_state.mean[1]), "locomotion seeds: the seeds' statistics are equal")
    for i in range(S):
        saved = load_params(os.path.join(save_path, cfg["ENV_NAME"],
                                         f"pqn_ac_{cfg['ENV_NAME']}_seed0_vmap{i}.safetensors"))
        check(set(saved) == {"actor", "critic", "norm_stats"}
              and torch.equal(saved["norm_stats"]["mean"], env_state.mean[i].cpu())
              and tuple(saved["critic"]["Dense_0"]["kernel"].shape)[0] == cfg.get("NUM_CRITICS", 2),
              f"locomotion seeds: the file of seed {i} does not hold its own critics and statistics")
    rate = S * outs["runner_state"][0]["actor"].timesteps / wall
    print(f"train locomotion (Hopper, both normalizers), {S} seeds as one program: {wall:.2f} s wall ({rate:.0f} "
          f"env-steps/s aggregate, 2 evals included); launches {launches}; norm_stats ({S}, {obs_dim}), each seed's "
          f"count {float(count)}, var range by seed "
          f"{[(round(float(v.min()), 4), round(float(v.max()), 4)) for v in env_state.var]}; the per-seed files "
          f"hold their own norm_stats")
    print(json.dumps({"seeds_locomotion_run": {"seeds": S, "env_steps_per_s": rate, "wall_s": wall,
                                               "launches": launches, "card": card}}))
    return launches_by_run, gates


def ac_run(cli, compose, make_env, load_params, counters, save_path, card, alg, steps, extra=()):
    """One unfused actor-critic run at full width with the checks every
    such run shares. Returns (greedy evals at each eval, none without
    TEST_DURING_TRAINING, and launches)."""
    import numpy as np
    import torch

    outs, wall, launches = train(cli, compose, alg, steps, save_path, counters, extra=extra, policy=())
    cfg = compose(alg=alg, overrides=list(extra))
    E, T, env_name = cfg["NUM_ENVS"], cfg["NUM_STEPS"], cfg["ENV_NAME"]
    updates = steps // (E * T)
    ts = outs["runner_state"][0]
    env_state = outs["runner_state"][1][1]
    m = {k: v.cpu().numpy() for k, v in outs["metrics"].items()}
    interval = max(1, int(updates * cfg["TEST_INTERVAL"]))
    tests = m.get("test/returned_episode_returns", np.zeros(0))
    check((len(tests) > 0) == cfg.get("TEST_DURING_TRAINING", False), f"{alg} ({env_name}): test/* metrics missing or kept")
    evals = np.concatenate([tests[:1], tests[interval - 1 :: interval]])
    check(ts["actor"].timesteps == updates * E * T, f"{alg}: wrong env-step count")
    check(all(p.device.type == "cuda" for st in ts.values() for p in st.network.parameters()),
          f"{alg}: a parameter is not on cuda")
    check(launches["lambda_returns"] == updates,
          f"{alg}: lambda_returns launched {launches['lambda_returns']} times, expected {updates}")
    others = {k: v for k, v in launches.items() if k != "lambda_returns" and v}
    check(not others, f"{alg}: another kernel launched: {others}")
    check(all(np.isfinite(v).all() for v in m.values()), f"{alg}: non-finite metrics")
    env, env_params = make_env(env_name)
    obs_dim, act_dim = env.observation_space(env_params).shape[0], env.action_space(env_params).shape[0]
    norm = {}
    if cfg["NORMALIZE_OBS"]:
        count = np.float32(np.float32(1e-4) + np.float32(E))
        for _ in range(updates * T):
            count = np.float32(count + np.float32(E))
        check(bool(torch.isfinite(env_state.mean).all() and torch.isfinite(env_state.var).all()),
              f"{alg}: non-finite observation statistics")
        check(env_state.count.item() == float(count),
              f"{alg}: observation statistics' count {env_state.count.item()}, expected {float(count)}")
        norm = {"count": env_state.count.item(),
                "var_range": [env_state.var.min().item(), env_state.var.max().item()]}
    saved = load_params(os.path.join(save_path, env_name, f"pqn_ac_{env_name}_seed0.safetensors"))
    a_h, c_h = cfg["ACTOR_HIDDEN_SIZES"], cfg["CRITIC_HIDDEN_SIZES"]
    shapes = {
        ("actor", "Dense_0"): (obs_dim, a_h[0]), ("actor", f"Dense_{len(a_h)}"): (a_h[-1], act_dim),
        ("critic", "Dense_0"): (2, obs_dim + act_dim, c_h[0]), ("critic", f"Dense_{len(c_h)}"): (2, c_h[-1], 1),
    }
    for (net, layer), shape in shapes.items():
        check(tuple(saved[net][layer]["kernel"].shape) == shape,
              f"{alg}: saved {net}/{layer} kernel {tuple(saved[net][layer]['kernel'].shape)}, expected {shape}")
    if cfg["NORMALIZE_OBS"]:
        check(set(saved) == {"actor", "critic", "norm_stats"}
              and all(tuple(saved["norm_stats"][k].shape) == (obs_dim,) for k in ("mean", "var"))
              and torch.equal(saved["norm_stats"]["mean"], env_state.mean.cpu()),
              f"{alg}: the saved norm_stats are not the run's (obs_dim,) statistics")
    else:
        check(set(saved) == {"actor", "critic"}, f"{alg}: saved tree {sorted(saved)}")
    print(
        f"train {alg} ({env_name}, pqn_ac, unfused): {ts['actor'].timesteps} env steps in {wall:.2f} s wall "
        f"({ts['actor'].timesteps / wall:.0f} env-steps/s, eval included); launches {launches}; greedy eval "
        f"returns at each eval {[round(float(v), 2) for v in evals]}"
    )
    print(json.dumps({f"{alg}_run": {
        "env": env_name, "env_steps": ts["actor"].timesteps, "updates": updates,
        "env_steps_per_s": ts["actor"].timesteps / wall, "wall_s": wall, "evals": [float(v) for v in evals],
        "best_eval_return": float(evals.max()) if len(evals) else None, "obs_norm": norm, "launches": launches,
        "card": card,
    }}))
    return evals, launches


def host_env_phase(cli, compose, load_params, counters, save_path, card):
    """Phase 6k, the host-env path: the port's envhost and plug-ins built
    with g++ (their build times), the pool's host env-steps/s on every
    native game and bundled plug-in, the pinned exchange buffers,
    pqn_host_minatar sync and ASYNC_ENVS on Breakout-MinAtar (the YAML as
    it stands) and on Pong-EH with the Nature CNN, each with one
    epsilon-greedy launch a rollout step over the training rows and one
    closure returns launch an update and no other kernel; then the host
    CartPole learning gate. Returns each run's launches and rates."""
    import numpy as np
    import torch

    from purejaxql_torch.algo.pqn_host import HostBuffers
    from purejaxql_torch.envs import hostpool

    t0 = time.perf_counter()
    per_lib = hostpool.build()
    print(f"host build: {time.perf_counter() - t0:.1f} s wall (g++, one a library, together), per library "
          f"{json.dumps(per_lib)}")
    hostpool.ensure_bundled_plugins()
    n_envs = 128 + 16
    rng = np.random.RandomState(0)
    pool_rates = {}
    for name in HOST_POOL_ENVS:
        pool = hostpool.HostEnvPool(name, n_envs, seed=0)
        obs = pool.reset()
        rew, done = np.empty(n_envs, np.float32), np.empty(n_envs, np.uint8)
        actions = rng.randint(0, pool.num_actions, (HOST_POOL_STEPS, n_envs)).astype(np.int32)
        t0 = time.perf_counter()
        for a in actions:
            pool.step_into(a, obs, rew, done)
        pool_rates[name] = HOST_POOL_STEPS * n_envs / (time.perf_counter() - t0)
        check(np.isfinite(obs).all(), f"host pool {name}: non-finite obs")
        if name == "Pong-EH":
            bufs = HostBuffers.allocate(pool, 32, 128, torch.device("cuda", 0))
            check(all(t.is_pinned() for t in (bufs.obs_pin, bufs.act_pin, bufs.rew_pin, bufs.done_pin)),
                  "pqn_host: the host exchange buffers are not pinned")
            bufs.obs_pin.numpy()[:] = obs
            bufs.cur.copy_(bufs.obs_pin, non_blocking=True)  # the first copy pays the setup
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bufs.cur.copy_(bufs.obs_pin, non_blocking=True)
            returned = time.perf_counter() - t0
            torch.cuda.synchronize()
            landed = time.perf_counter() - t0
            check(torch.equal(bufs.cur.cpu(), torch.from_numpy(obs)), "pqn_host: the pinned obs copy differs")
            print(f"host exchange: {obs.nbytes / 1e6:.1f} MB of Pong-EH obs from pinned memory, copy_ returned after "
                  f"{1e6 * returned:.0f} us, landed after {1e6 * landed:.0f} us")
        pool.close()
    print(json.dumps({"host_pool_env_steps_per_s": pool_rates, "envs": n_envs, "steps": HOST_POOL_STEPS,
                      "cpus": len(os.sched_getaffinity(0)), "card": card}))

    def host_run(name, alg, steps, extra, steps_per_update=128 * 32, rollout_steps=32, test=True):
        outs, wall, launches = train(cli, compose, alg, steps, save_path, counters, extra=extra,
                                     policy=(("EXPLORATION_KERNEL", "pallas"),))
        updates = steps // steps_per_update
        ts = outs["runner_state"][0]
        m = {k: v.cpu().numpy() for k, v in outs["metrics"].items()}
        check(launches["eps_greedy"] == updates * rollout_steps and launches["lambda_returns_closure"] == updates,
              f"{name}: launches {launches}, expected {updates * rollout_steps} eps_greedy and {updates} closure")
        others = {k: v for k, v in launches.items() if k not in ("eps_greedy", "lambda_returns_closure") and v}
        check(not others, f"{name}: another kernel launched: {others}")
        check(ts.timesteps == updates * steps_per_update and ts.n_updates == updates, f"{name}: wrong env-step count")
        check(all(p.device.type == "cuda" for p in ts.network.parameters()), f"{name}: a parameter is not on cuda")
        check(all(v.shape == (updates,) and np.isfinite(v).all() for v in m.values()), f"{name}: non-finite metrics")
        check(("test/returned_episode_returns" in m) == test, f"{name}: test/* metrics {'missing' if test else 'kept'}")
        rate = ts.timesteps / wall
        print(f"train {name}: {ts.timesteps} env steps in {wall:.2f} s wall ({rate:.0f} env-steps/s); launches "
              f"{launches}; last returned_episode_returns {m['returned_episode_returns'][-1]:.3f}"
              + (f", test {m['test/returned_episode_returns'][-1]:.3f}" if test else ""))
        return outs, m, rate, launches

    rates, launches_by_run = {}, {}
    for env_name, updates, extra, trunk in (
        ("Breakout-MinAtar", HOST_BREAKOUT_UPDATES, ["TOTAL_TIMESTEPS_DECAY=10000000"], "minatar"),
        ("Pong-EH", HOST_PONG_UPDATES, ["TOTAL_TIMESTEPS_DECAY=10000000", "CNN_TRUNK=nature", "SCORE_GAME=Pong-v5"],
         "nature"),
    ):
        for mode in ("sync", "async"):
            name = f"pqn_host {env_name} ({trunk} CNN, {mode})"
            outs, m, rates[(env_name, mode)], launches_by_run[(env_name, mode)] = host_run(
                name, "pqn_host_minatar", updates * 128 * 32,
                [f"ENV_NAME={env_name}", *extra, f"ASYNC_ENVS={mode == 'async'}"])
            keys = {"update", "td_loss", "returned_episode_returns"} if mode == "async" else {
                "env_step", "td_loss", "reward_per_step", "done_rate", "returned_episode_returns",
                "returned_episode_lengths", "test/returned_episode_lengths"}
            check(keys <= set(m), f"{name}: metrics {sorted(m)} lack {sorted(keys - set(m))}")
            check(env_name != "Pong-EH" or "test/human_normalized_score" in m, f"{name}: no human_normalized_score")
            net = outs["runner_state"][0].network
            saved = load_params(os.path.join(save_path, env_name, f"pqn_host_{env_name}_seed0.safetensors"))
            conv = saved["CNN_0"]["Conv_0"]["kernel"]
            check(tuple(conv.shape) == ((8, 8, 4, 32) if trunk == "nature" else (3, 3, 4, 16))
                  and torch.equal(conv, net.CNN_0.Conv_0.weight.permute(2, 3, 1, 0).cpu()),
                  f"{name}: the saved Conv_0 is not the network's")
            if trunk == "nature":
                check(tuple(saved["CNN_0"]["Dense_0"]["kernel"].shape) == (3136, 512), f"{name}: Dense_0 not 3136 x 512")
        print(json.dumps({"host_run": env_name, "trunk": trunk, "updates": updates,
                          "env_steps_per_s": {"sync": rates[(env_name, "sync")], "async": rates[(env_name, "async")]},
                          "launches": launches_by_run[(env_name, "sync")], "card": card}))

    outs, m, gate_rate, gate_launches = host_run(
        "pqn_host CartPole-v1 gate (sync)", "pqn_cartpole", HOST_GATE_STEPS, list(HOST_GATE_EXTRA),
        steps_per_update=64 * 32, test=False)
    dr = m["done_rate"]
    n = len(dr)
    # the JAX test's tenths, dr[: n // 10] and dr[-n // 10:]
    early, late = float(dr[: n // 10].mean()), float(dr[-n // 10:].mean())
    print(json.dumps({"host_gate": "CartPole-v1", "env_steps_per_s": gate_rate, "first_tenth_done_rate": early,
                      "last_tenth_done_rate": late, "gate": "last < first / 2", "launches": gate_launches,
                      "card": card}))
    check(late < early / 2, f"pqn_host CartPole-v1 did not learn: done rate {early} -> {late}, not halved")
    return launches_by_run, rates


def step_envs(compose, make_env, card, dev, names, alg_of, tag):
    """Each env of ``names`` built on the card and stepped CLASSIC_STEP_STEPS
    times with random actions (beyond the box, for a Box) over
    CLASSIC_STEP_ENVS envs: finite obs and rewards of the space's shape. For
    each distinct (class, task) the raw step_env time beside the step
    through the wrappers of ``alg_of(name, discrete)``'s trainer, one JSON
    line under ``tag`` each."""
    import torch

    from purejaxql_torch.algo.pqn import build_env
    from purejaxql_torch.algo.pqn_ac import build_ac_env

    gen = torch.Generator(device=dev).manual_seed(0)
    E = CLASSIC_STEP_ENVS
    timed = set()
    for name in names:
        env, params = make_env(name)
        space = env.action_space(params)
        discrete = hasattr(space, "n")

        def actions():
            if discrete:
                return torch.randint(0, space.n, (E,), generator=gen, device=dev)
            return torch.rand(E, *space.shape, generator=gen, device=dev) * 2.4 - 1.2

        obs, state = env.reset(gen, E, params)
        for _ in range(CLASSIC_STEP_STEPS):
            obs, state, rew, done, _ = env.step(gen, state, actions(), params)
        check(obs.device == dev and obs.shape == (E, *env.observation_space(params).shape)
              and bool(torch.isfinite(obs).all() and torch.isfinite(rew).all()),
              f"{name}: non-finite obs or rewards on the card, or the wrong obs shape")
        task = (type(env).__name__, getattr(env, "task", None), getattr(env, "sparse", None),
                getattr(env, "orientation", None))
        if task in timed:
            continue
        timed.add(task)
        act = actions()
        raw_ms = cuda_time_ms(lambda: env.step_env(state, act, params, env.step_draws(gen, E)), 16)
        cfg = compose(alg=alg_of(name, discrete), overrides=[f"ENV_NAME={name}"])
        wrapped = build_env(cfg)[0] if discrete else build_ac_env(cfg)[0]
        _, wstate = wrapped.reset(gen, E, params)
        wrapped_ms = cuda_time_ms(lambda: wrapped.step(gen, wstate, act, params), 16)
        print(json.dumps({tag: name, "envs": E, "raw_step_env_ms": raw_ms, "wrapped_step_ms": wrapped_ms,
                          "wrappers": type(wrapped).__name__, "card": card}))


def classic_env_phase(cli, compose, make_env, load_params, counters, save_path, card, dev):
    """Phase 6l, the single-file classic envs: every one of their registry
    names built on the card and stepped with random actions, each task's
    raw step_env time beside its step through the trainer's wrappers; the
    four discrete envs trained at pqn_cartpole's width (one epsilon-greedy
    launch a rollout step, one returns launch an update, no other kernel);
    one task of each dm-suite module at pqn_dm_suite's (ac_run's checks).
    Returns each run's launches."""
    import numpy as np

    step_envs(compose, make_env, card, dev, CLASSIC_FF_ENVS + CLASSIC_AC_NAMES,
              lambda name, discrete: "pqn_cartpole" if discrete else "pqn_dm_suite", "classic_env_step")
    launches_by_run = {}
    for name in CLASSIC_FF_ENVS:
        updates = CLASSIC_FF_UPDATES
        outs, wall, launches = train(cli, compose, "pqn_cartpole", updates * 64 * 32, save_path, counters,
                                     extra=[f"ENV_NAME={name}", f"TEST_INTERVAL={CLASSIC_FF_TEST_INTERVAL}"],
                                     policy=(("EXPLORATION_KERNEL", "pallas"),))
        ts = outs["runner_state"][0]
        m = {k: v.cpu().numpy() for k, v in outs["metrics"].items()}
        check(launches["eps_greedy"] == updates * 64 and launches["lambda_returns"] == updates,
              f"{name}: launches {launches}, expected {updates * 64} eps_greedy and {updates} lambda_returns")
        others = {k: v for k, v in launches.items() if k not in ("eps_greedy", "lambda_returns") and v}
        check(not others, f"{name}: another kernel launched: {others}")
        check(ts.timesteps == updates * 64 * 32 and ts.n_updates == updates, f"{name}: wrong env-step count")
        check(all(p.device.type == "cuda" for p in ts.network.parameters()), f"{name}: a parameter is not on cuda")
        check({"test/returned_episode_returns", "test/returned_episode_lengths"} <= set(m)
              and all(v.shape == (updates,) and np.isfinite(v).all() for v in m.values()),
              f"{name}: metrics non-finite or without the test/* keys: {sorted(m)}")
        saved = load_params(os.path.join(save_path, name, f"pqn_{name}_seed0.safetensors"))
        obs_dim = make_env(name)[0].observation_space(make_env(name)[1]).shape[0]
        check(tuple(saved["Dense_0"]["kernel"].shape) == (obs_dim, 256), f"{name}: saved Dense_0 not ({obs_dim}, 256)")
        rate = ts.timesteps / wall
        print(f"train {name} (pqn_cartpole, unfused): {ts.timesteps} env steps in {wall:.2f} s wall ({rate:.0f} "
              f"env-steps/s, eval included); launches {launches}; last returned_episode_returns "
              f"{m['returned_episode_returns'][-1]:.3f}, last greedy eval {m['test/returned_episode_returns'][-1]:.3f}")
        print(json.dumps({"classic_ff_run": name, "updates": updates, "env_steps_per_s": rate, "wall_s": wall,
                          "launches": launches, "last_eval": float(m["test/returned_episode_returns"][-1]),
                          "card": card}))
        launches_by_run[name] = launches
    for name in CLASSIC_AC_RUNS:
        acfg = compose(alg="pqn_dm_suite")
        _, launches_by_run[name] = ac_run(
            cli, compose, make_env, load_params, counters, save_path, card, "pqn_dm_suite",
            AC_SHORT_UPDATES * acfg["NUM_STEPS"] * acfg["NUM_ENVS"],
            extra=(f"ENV_NAME={name}", "TEST_DURING_TRAINING=False"))
    return launches_by_run


def shared_sim_phase(cli, compose, make_env, load_params, counters, save_path, card, dev):
    """Phase 6m, the shared simulators (locomotion3d, manipulation2d): every
    one of their registry names built on the card and stepped with random
    actions, each (class, task)'s raw step_env time beside its step through
    the AC trainer's wrappers; pqn_locomotion on a quadruped and a biped
    task, pqn_manipulation on a task of each class (ac_run's checks: one
    returns launch an update, no other kernel). Returns each run's
    launches."""
    step_envs(compose, make_env, card, dev, SIM_LOCOMOTION_NAMES + SIM_MANIPULATION_NAMES,
              lambda name, discrete: "pqn_locomotion" if name in SIM_LOCOMOTION_NAMES else "pqn_manipulation",
              "sim_env_step")
    launches_by_run = {}
    for alg, name in SIM_RUNS:
        cfg = compose(alg=alg)
        evals = ((f"TEST_INTERVAL={AC_SHORT_TEST_INTERVAL}",) if name in SIM_EVAL_RUNS
                 else ("TEST_DURING_TRAINING=False",))
        _, launches_by_run[name] = ac_run(
            cli, compose, make_env, load_params, counters, save_path, card, alg,
            SIM_UPDATES * cfg["NUM_STEPS"] * cfg["NUM_ENVS"], extra=(f"ENV_NAME={name}", *evals))
    return launches_by_run


def _to_cpu(tree):
    """A tree of lists and tuples of tensors, each copied to the CPU."""
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree.cpu()


def forward_gap(network, args, call=None):
    """(max |Q on the card - Q on a CPU copy|, max |Q on the CPU|): the
    trained network's eval-mode forward on ``args`` and a copy of it, its
    parameters and running statistics, with the args on the CPU. ``call``
    applies a network to args (by default ``network(*args, train=False)``,
    the Q-values the second output of a recurrent network)."""
    import torch

    def q_of(net, a):
        out = call(net, *a) if call is not None else net(*a, train=False)
        return out[1] if isinstance(out, tuple) else out

    with torch.no_grad():
        q = q_of(network, args).float().cpu()
        q_cpu = q_of(copy.deepcopy(network).cpu(), _to_cpu(args)).float()
    return float((q - q_cpu).abs().max()), float(q_cpu.abs().max())


def network_variants_phase(cli, compose, counters, save_path, card, bars=False):
    """Phase 6n: each run of NETWORK_RUNS through ``train`` (the counts set
    to 0 just before, read just after), its launches held to its family's:
    the unfused FF runs one epsilon-greedy launch a rollout step and one
    returns launch an update (none under 1-step TD), the recurrent runs on
    the module path one epsilon-greedy launch a prefill and rollout step and
    one closure returns launch a grad step, VDN one closure launch a grad
    step, the host runs one epsilon-greedy launch a rollout step and one
    closure launch an update; no other kernel (no GRU scan: FAST_BPTT stays
    off). The env-step count, finite losses, parameters on cuda, and the
    forward on the card against a CPU copy: within 1e-4 of max(1, |Q|) in
    float32, 2**-4 in bfloat16 (bfloat16 products that the card and the CPU
    round apart). With ``bars``, then scripts/network_learning_bar.py, its
    runs 7 at once, held to its bars. Returns each run's launches."""
    import numpy as np
    import torch

    from purejaxql_torch.algo.pqn_vdn import agents_forward

    t_phase = time.perf_counter()
    launches_by_run = {}
    for name, alg, extra, kind in NETWORK_RUNS:
        cfg = compose(alg=alg, overrides=list(extra))
        seeds = cfg.get("NUM_SEEDS", 1)
        per_update = cfg["NUM_STEPS"] * cfg["NUM_ENVS"]
        updates = NETWORK_CRAFTAX_UPDATES if alg == "pqn_craftax" else NETWORK_UPDATES
        policy = () if kind == "vdn" else (("EXPLORATION_KERNEL", "pallas"),)
        outs, wall, launches = train(cli, compose, alg, updates * per_update, save_path, counters,
                                     extra=[*extra, "TEST_DURING_TRAINING=False"], policy=policy)
        check(not cfg.get("FUSED_ROLLOUT") and not cfg.get("FAST_BPTT") and not cfg.get("FAST_TARGETS"),
              f"{name}: the cuda policy turned on a path this configuration does not take")
        ts = outs["runner_state"][0]
        grad_steps = updates * cfg["NUM_EPOCHS"] * cfg["NUM_MINIBATCHES"]
        if kind == "ff":
            want = {"eps_greedy": updates * cfg["NUM_STEPS"],
                    "lambda_returns": updates if cfg.get("Q_LAMBDA", True) else 0}
        elif kind == "rnn":
            want = {"eps_greedy": cfg.get("MEMORY_WINDOW", 0) + (updates + 1) * cfg["NUM_STEPS"],
                    "lambda_returns_closure": grad_steps}
        elif kind == "vdn":
            want = {"lambda_returns_closure": grad_steps}
        else:
            want = {"eps_greedy": updates * cfg["NUM_STEPS"], "lambda_returns_closure": updates}
        got = {k: v for k, v in launches.items() if v}
        check(got == {k: v for k, v in want.items() if v}, f"{name}: launches {got}, expected {want}")
        check(ts.timesteps == updates * per_update, f"{name}: {ts.timesteps} env steps, expected {updates * per_update}")
        check(all(p.device.type == "cuda" for p in ts.network.parameters()), f"{name}: a parameter is not on cuda")
        loss = outs["metrics"]["td_loss"]
        check(bool(torch.isfinite(loss).all()), f"{name}: non-finite td_loss")
        net = ts.network
        if kind == "ff":
            gap, q_max = forward_gap(net, (outs["runner_state"][1][0],))
        elif kind == "rnn":
            hidden, obs, done, last_action, _ = outs["runner_state"][2]
            gap, q_max = forward_gap(net, (hidden, obs[None], done[None], last_action[None]))
        elif kind == "vdn":
            hidden, obs, dones, _ = outs["runner_state"][2]
            agents = [a for a in dones if a != "__all__"]
            args = (hidden, torch.stack([obs[a] for a in agents]), torch.stack([dones[a] for a in agents]).float())
            gap, q_max = forward_gap(net, args, call=agents_forward)
        elif "async" in name:  # the async trainer keeps no obs: byte frames
            gap, q_max = forward_gap(net, (torch.randint(0, 256, (64, 84, 84, 4), device="cuda").float(),))
        else:
            gap, q_max = forward_gap(net, (outs["runner_state"][1][:cfg["NUM_ENVS"]].view(-1, 84, 84, 4),))
        bf16 = bool(cfg.get("BF16_COMPUTE"))
        check(gap <= (2.0**-4 if bf16 else 1e-4) * max(1.0, q_max),
              f"{name}: the forward on the card is {gap} off the CPU copy's (max |Q| {q_max})")
        rate = ts.timesteps / wall
        print(f"train {name} ({alg} {' '.join(extra)}): {ts.timesteps} env steps in {wall:.2f} s wall "
              f"({rate:.0f} env-steps/s); launches {launches}; card vs CPU forward max |dQ| {gap:.3g} "
              f"(max |Q| {q_max:.3g})")
        print(json.dumps({"network_run": name, "alg": alg, "overrides": list(extra), "updates": updates,
                          "env_steps_per_s": rate, "wall_s": wall, "launches": launches, "forward_gap": gap,
                          "q_max": q_max, "bf16": bf16, "td_loss": [float(v) for v in np.ravel(loss.cpu())][-4:],
                          "card": card}))
        launches_by_run[name] = launches
    print(f"phase 6n (network configurations): {time.perf_counter() - t_phase:.1f} s wall")
    if bars:
        script = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts", "network_learning_bar.py")
        done = subprocess.run([sys.executable, script, "--jobs", "7"], timeout=3000)
        check(done.returncode == 0, f"scripts/network_learning_bar.py failed (exit {done.returncode})")
    return launches_by_run


def _same_state_files(a: str, b: str) -> bool:
    """Two safetensors files with the same keys, dtypes, shapes and bits."""
    import torch
    from safetensors.torch import load_file

    x, y = load_file(a), load_file(b)
    return x.keys() == y.keys() and all(
        x[k].dtype == y[k].dtype and x[k].shape == y[k].shape and torch.equal(x[k], y[k]) for k in x)


def _param_gap(a, b):
    """The largest |difference| over two networks' parameters and buffers,
    0.0 where they are bit-equal."""
    import torch

    gap = 0.0
    for x, y in zip([*a.parameters(), *a.buffers()], [*b.parameters(), *b.buffers()]):
        if not torch.equal(x, y):
            gap = max(gap, float((x.double() - y.double()).abs().max()))
    return gap


def staged_tooling_phase(cli, compose, counters, save_path, card, bars=False):
    """Phase 6o, the staged API and its tooling at full width, each run with
    the counts set to 0 just before and read just after: the stepwise CLI
    (one epsilon-greedy launch a rollout step, one returns launch an update;
    the state file round-trips bit for bit and the resumed run continues its
    counters); the segmented trainer against one train on pqn_cartpole
    (fused: one CartPole rollout and one returns launch an update) and on
    pqn_rnn_memory_chain (the GRU scan kernels and the closure returns a grad
    step), bit for bit or within 1e-5; LOG_VIA_CALLBACK on the four trainers
    (one finite row every CALLBACK_INTERVAL updates); HYP_TUNE; the rollout
    tool on the stepwise run's weights and --gif on a saved Breakout run;
    the stage timings. Returns the launches of the phase's runs, summed."""
    import contextlib
    import io
    import shutil

    import numpy as np
    import torch

    from purejaxql_torch.algo import pqn, pqn_rnn
    from purejaxql_torch.algo.segmented import train_segmented
    from purejaxql_torch.algo.stages import make_stages
    from purejaxql_torch.core.checkpoint import load_state, save_run, save_state
    from purejaxql_torch.scripts import rollout
    from purejaxql_torch.utils.profiling import stage_timings

    t_phase = time.perf_counter()
    total = {k: 0 for k in counters}

    def counted(fn, *args, **kw):
        for f in counters.values():
            f.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {k: f.launches for k, f in counters.items()}
        for k, v in got.items():
            total[k] += v
        return out, wall, {k: v for k, v in got.items() if v}

    # stepwise: 8 updates with a checkpoint every 4, then resumed to 12
    sw_dir = os.path.join(save_path, "stepwise")
    shutil.rmtree(sw_dir, ignore_errors=True)
    ckpt = os.path.join(sw_dir, "CartPole-v1_state.safetensors")
    cp = compose(alg="pqn_cartpole", overrides=["TRAINER=stepwise"])
    per_update = cp["NUM_ENVS"] * cp["NUM_STEPS"]
    sw_args = ["+alg=pqn_cartpole", "TRAINER=stepwise", f"SAVE_PATH={sw_dir}",
               f"TOTAL_TIMESTEPS_DECAY={STEPWISE_RESUME_TO * per_update}"]
    check(cp.get("EXPLORATION_KERNEL") == "pallas" and not cp.get("FUSED_ROLLOUT"),
          "stepwise: the cuda policy did not leave the config unfused with the epsilon-greedy kernel")
    for tag, updates, extra in (
        ("stepwise", STEPWISE_UPDATES, [f"CHECKPOINT_EVERY={STEPWISE_CHECKPOINT_EVERY}"]),
        ("stepwise resumed", STEPWISE_RESUME_TO - STEPWISE_UPDATES, [f"RESUME_FROM={ckpt}"]),
    ):
        steps = (STEPWISE_UPDATES if tag == "stepwise" else STEPWISE_RESUME_TO) * per_update
        _, wall, got = counted(cli.main, [*sw_args, f"TOTAL_TIMESTEPS={steps}", *extra])
        want = {"eps_greedy": updates * cp["NUM_STEPS"], "lambda_returns": updates}
        check(got == want, f"{tag}: launches {got}, expected {want}")
        print(f"{tag} (pqn_cartpole, TRAINER=stepwise): {updates} updates in {wall:.2f} s wall "
              f"({updates * per_update / wall:.0f} env-steps/s); launches {got}")
        if tag == "stepwise":
            stages = make_stages(cp)
            state = load_state(stages.init_agent(torch.Generator().manual_seed(1)), ckpt)
            again = os.path.join(sw_dir, "again.safetensors")
            save_state(state, again)
            check(_same_state_files(ckpt, again), "stepwise: the state file does not round-trip bit for bit")
            check(next(state.network.parameters()).device.type == "cuda", "stepwise: the state did not load on cuda")
            check((state.n_updates, state.grad_steps, state.timesteps) == (
                STEPWISE_UPDATES, STEPWISE_UPDATES * cp["NUM_EPOCHS"] * cp["NUM_MINIBATCHES"],
                STEPWISE_UPDATES * per_update), "stepwise: wrong counters in the state")
    state = load_state(make_stages(cp).init_agent(torch.Generator().manual_seed(1)), ckpt)
    check(state.n_updates == STEPWISE_RESUME_TO, f"stepwise resumed: {state.n_updates} updates in the state")

    # the rollout tool on the stepwise run's weights, and --gif on Breakout
    run_dir = os.path.join(sw_dir, "run")
    save_run(state.network, cp, run_dir, "pqn_CartPole-v1_stepwise")
    traj = os.path.join(sw_dir, "traj.npz")
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        check(rollout.main(["--run-dir", run_dir, "--episodes", "8", "--save-traj", traj]) == 0, "rollout tool failed")
    rets = np.load(traj)["returns"]
    check(rets.shape == (8,) and np.isfinite(rets).all(), f"rollout tool: returns {rets}")
    bo_dir = os.path.join(sw_dir, "breakout")
    os.makedirs(bo_dir)
    for name in ("pqn_Breakout-MinAtar_seed0.safetensors", "pqn_Breakout-MinAtar_seed0_config.yaml"):
        shutil.copy(os.path.join(save_path, "Breakout-MinAtar", name), bo_dir)
    gif = os.path.join(sw_dir, "breakout.gif")
    with contextlib.redirect_stdout(buf):
        check(rollout.main(["--run-dir", bo_dir, "--episodes", "2", "--max-steps", "500", "--gif", gif]) == 0,
              "rollout tool --gif failed")
    with open(gif, "rb") as f:
        check(f.read(6) == b"GIF89a", "rollout tool: not a GIF")
    print(f"rollout tool: {time.perf_counter() - t0:.2f} s wall; the stepwise CartPole weights' greedy returns "
          f"{[float(r) for r in rets]}; Breakout --gif {os.path.getsize(gif)} bytes; "
          + " | ".join(line for line in buf.getvalue().splitlines() if line.startswith(("returns", "gif"))))

    # the segmented trainer against one train: CartPole fused, MemoryChain
    for alg, updates, segments, make_train in (
        ("pqn_cartpole", SEG_FF_UPDATES, SEG_FF, pqn.make_train),
        ("pqn_rnn_memory_chain", SEG_RNN_UPDATES, 2, pqn_rnn.make_train),
    ):
        cfg = compose(alg=alg, overrides=["TEST_DURING_TRAINING=False"])
        per = cfg["NUM_ENVS"] * cfg["NUM_STEPS"]
        cfg.update(TOTAL_TIMESTEPS=updates * per, TOTAL_TIMESTEPS_DECAY=updates * per)
        mono, mono_wall, mono_launches = counted(lambda: make_train(cfg)())
        seg, seg_wall, seg_launches = counted(train_segmented, cfg, segments, make_train=make_train)
        check(mono_launches == seg_launches, f"segmented {alg}: launches {seg_launches} against {mono_launches}")
        grad_steps = updates * cfg["NUM_EPOCHS"] * cfg["NUM_MINIBATCHES"]
        if alg == "pqn_cartpole":
            check(cfg.get("FUSED_ROLLOUT") is True, "segmented pqn_cartpole: not fused")
            want = {"cartpole_rollout": updates, "lambda_returns": updates}
        else:
            check(cfg.get("PALLAS_BPTT") is True, "segmented MemoryChain: no GRU scan kernels")
            want = {"gru_scan_fwd": grad_steps, "gru_scan_bwd": grad_steps, "lambda_returns_closure": grad_steps,
                    "eps_greedy": cfg.get("MEMORY_WINDOW", 0) + (updates + 1) * cfg["NUM_STEPS"]}
        check(seg_launches == want, f"segmented {alg}: launches {seg_launches}, expected {want}")
        ts, mts = seg["runner_state"][0], mono["runner_state"][0]
        check((ts.timesteps, ts.n_updates, ts.grad_steps, ts.step) == (
            mts.timesteps, mts.n_updates, mts.grad_steps, mts.step) == (updates * per, updates, grad_steps, grad_steps),
              f"segmented {alg}: counters differ")
        gap = _param_gap(mts.network, ts.network)
        check(gap <= 1e-5, f"segmented {alg}: params {gap} off one train's")
        check(all(v.shape[:2] == (1, updates) for v in seg["metrics"].values()), f"segmented {alg}: metrics shape")
        print(f"segmented {alg}: {segments} segments of {updates // segments} updates in {seg_wall:.2f} s wall, "
              f"one train of {updates} in {mono_wall:.2f} s; launches {seg_launches}; params "
              + ("bit-equal" if gap == 0.0 else f"max |difference| {gap:.3g}"))
        print(json.dumps({"segmented": alg, "segments": segments, "updates": updates, "wall_s": seg_wall,
                          "monolith_wall_s": mono_wall, "launches": seg_launches, "param_gap": gap, "card": card}))
    if bars:
        cfg = compose(alg="pqn_cartpole", overrides=[
            f"TOTAL_TIMESTEPS={SEG_LEARNING_STEPS}", f"TOTAL_TIMESTEPS_DECAY={SEG_LEARNING_STEPS}", "NUM_ENVS=16",
            "NUM_STEPS=32", "NUM_MINIBATCHES=4", "NUM_EPOCHS=2", "TEST_DURING_TRAINING=False"])
        outs, wall, got = counted(train_segmented, cfg, 4)
        rets = outs["metrics"]["returned_episode_returns"][0].cpu().numpy()
        first, last = float(rets[:20].mean()), float(rets[-20:].mean())
        print(f"segmented CartPole learning check ({SEG_LEARNING_STEPS} env steps, 4 segments): first 20 updates' "
              f"mean return {first:.2f}, last 20's {last:.2f} in {wall:.2f} s wall; launches {got}")
        check(last > 2 * first, f"segmented CartPole did not learn: last 20 {last} <= 2 x first 20 {first}")

    # LOG_VIA_CALLBACK on the four trainers
    for alg in CALLBACK_RUNS:
        cfg = compose(alg=alg)
        jsonl = os.path.join(sw_dir, "callback.jsonl")
        if os.path.exists(jsonl):
            os.remove(jsonl)
        steps = CALLBACK_UPDATES * cfg["NUM_ENVS"] * cfg["NUM_STEPS"]
        args = [f"+alg={alg}", f"TOTAL_TIMESTEPS={steps}", "TEST_DURING_TRAINING=False", "LOG_VIA_CALLBACK=True",
                f"LOG_INTERVAL={CALLBACK_INTERVAL}", f"LOG_JSONL={jsonl}", f"SAVE_PATH={os.path.join(sw_dir, 'runs')}"]
        if "TOTAL_TIMESTEPS_DECAY" in cfg:
            args.append(f"TOTAL_TIMESTEPS_DECAY={steps}")
        _, wall, got = counted(cli.main, args)
        with open(jsonl) as f:
            rows = [json.loads(line) for line in f]
        want = list(range(CALLBACK_INTERVAL, CALLBACK_UPDATES + 1, CALLBACK_INTERVAL))
        check([r["update_steps"] for r in rows] == want, f"callback {alg}: rows {[r.get('update_steps') for r in rows]}")
        check(all(np.isfinite(v) for r in rows for v in r.values() if isinstance(v, (int, float))),
              f"callback {alg}: a row is not finite")
        print(f"callback {alg}: {len(rows)} rows of {len(rows[0])} keys over {CALLBACK_UPDATES} updates in "
              f"{wall:.2f} s wall; launches {got}")

    # HYP_TUNE: the local random search, the port's train() a trial. Where
    # wandb is installed, run_sweep takes wandb's sweep, which needs its
    # service: the machine has no network, so wandb's import is blocked here
    buf = io.StringIO()
    wandb = sys.modules.get("wandb")
    sys.modules["wandb"] = None
    try:
        with contextlib.redirect_stdout(buf):
            _, wall, got = counted(cli.main, [
                "+alg=pqn_cartpole", "HYP_TUNE=True", f"SWEEP_COUNT={SWEEP_TRIALS}", "TEST_DURING_TRAINING=False",
                f"TOTAL_TIMESTEPS={SWEEP_UPDATES * per_update}", f"TOTAL_TIMESTEPS_DECAY={SWEEP_UPDATES * per_update}"])
    finally:
        if wandb is None:
            del sys.modules["wandb"]
        else:
            sys.modules["wandb"] = wandb
    best = json.loads(buf.getvalue().strip().splitlines()[-1])
    check(best["best"]["LR"] in (0.001, 0.0005, 0.0001, 0.00005) and np.isfinite(best["score"]),
          f"sweep: {best}")
    print(f"sweep (HYP_TUNE, {SWEEP_TRIALS} trials of {SWEEP_UPDATES} updates): {wall:.2f} s wall; best {best}; "
          f"launches {got}")

    # the stage timings at full width (the eval: 128 envs x 500 steps)
    stages = make_stages(compose(alg="pqn_cartpole", overrides=["TRAINER=stepwise", "TEST_DURING_TRAINING=True"]))
    ms = {k.replace("_s", "_ms"): 1e3 * v for k, v in stage_timings(stages).items()}
    print(f"stage timings (pqn_cartpole, the stages' unfused rollout, best of 3): "
          + ", ".join(f"{k} {v:.2f}" for k, v in ms.items()) + f" on {card}")
    print(json.dumps({"stage_timings_ms": ms, "card": card}))
    launched = {k: v for k, v in total.items() if v}
    print(f"phase 6o (staged API and tooling): {time.perf_counter() - t_phase:.1f} s wall; launches {launched}")
    return total


def kernel_counters():
    """Each kernel's wrapper by kernel name: the wrapper adds one to its
    ``launches`` where it launches its kernel."""
    from purejaxql_torch.ops import asterix_rollout as ar
    from purejaxql_torch.ops import breakout_rollout as br
    from purejaxql_torch.ops import cartpole_rollout as cr
    from purejaxql_torch.ops import eps_greedy as eg
    from purejaxql_torch.ops import freeway_rollout as fr
    from purejaxql_torch.ops import gru_scan as gs
    from purejaxql_torch.ops import lambda_returns as lr
    from purejaxql_torch.ops import pendulum_rollout as pr
    from purejaxql_torch.ops import seaquest_rollout as sq
    from purejaxql_torch.ops import space_invaders_rollout as sr

    return {
        "lambda_returns": lr.lambda_returns,
        "lambda_returns_closure": lr.lambda_returns_closure,
        "cartpole_rollout": cr.cartpole_rollout,
        "breakout_rollout": br.breakout_rollout,
        "asterix_rollout": ar.asterix_rollout,
        "freeway_rollout": fr.freeway_rollout,
        "space_invaders_rollout": sr.space_invaders_rollout,
        "seaquest_rollout": sq.seaquest_rollout,
        "gru_scan_fwd": gs.gru_scan_fwd,
        "gru_scan_bwd": gs.gru_scan_bwd,
        "pendulum_ac_rollout": pr.pendulum_ac_rollout,
        "eps_greedy": eg.eps_greedy,
    }


def sharded_config(compose, spec, bars):
    """A phase 6p run's global config and its update count."""
    name, alg, extra, _, updates = spec
    cfg = compose(alg=alg, overrides=list(extra))
    per_update = cfg["NUM_ENVS"] * cfg["NUM_STEPS"]
    if name == SHARDED_GATE_RUN and bars:
        updates = SHARDED_GATE_STEPS // per_update
    steps = updates * per_update
    return compose(alg=alg, overrides=[f"TOTAL_TIMESTEPS={steps}", f"TOTAL_TIMESTEPS_DECAY={steps}", *extra]), updates


def sharded_expected(name, local, updates):
    """A rank's launches in a phase 6p run by the single-process formula at
    its local shapes: one rollout kernel and one returns an update (fused),
    one epsilon-greedy a rollout step (unfused FF; the recurrent trainer's
    prefill too), each GRU kernel and the closure returns once a grad step,
    the fused eval's chunks (EVAL_EARLY_EXIT off: every chunk runs)."""
    from purejaxql_torch.envs import make as make_env

    T, U = local["NUM_STEPS"], updates
    grad_steps = U * local["NUM_EPOCHS"] * local["NUM_MINIBATCHES"]
    if name in ("cartpole unfused", "cartpole batch_norm"):
        return {"eps_greedy": U * T, "lambda_returns": U}
    if name == SHARDED_GATE_RUN:
        max_steps = make_env(local["ENV_NAME"])[1].max_steps_in_episode
        evals = 1 + U // max(1, int(U * local["TEST_INTERVAL"]))
        return {"cartpole_rollout": U + evals * -(-max_steps // T), "lambda_returns": U}
    if name in ("cartpole fused", "seeds", "nccl"):
        return {"cartpole_rollout": U, "lambda_returns": U}
    if name == "segmented":  # one resumable run and the segmented one
        return {"cartpole_rollout": 2 * U, "lambda_returns": 2 * U}
    if name == "breakout fused":
        return {"breakout_rollout": U, "lambda_returns": U}
    if name == "pendulum fused":
        return {"pendulum_ac_rollout": U, "lambda_returns": U}
    gru = {"gru_scan_fwd": grad_steps, "gru_scan_bwd": grad_steps, "lambda_returns_closure": grad_steps}
    if name == "rnn cartpole":
        return {"eps_greedy": local["MEMORY_WINDOW"] + T + U * T, **gru}
    return gru  # vdn spread: masked epsilon-greedy, no kernel


def _rank_state(train_state):
    from purejaxql_torch.parallel.spmd import named_state

    return {k: v.detach().cpu().clone() for k, v in named_state(train_state).items()}


def _allreduce_ms(optimizers, group, iters=20):
    """The mean wall time of one gradient all-reduce over ``group``
    (``parallel/mesh.py:pmean_``, what each optimizer runs a step: the
    actor-critic trainer's two, the others' one) at the optimizers'
    parameter sizes, the ranks lined up by a barrier first."""
    import torch
    import torch.distributed as dist

    from purejaxql_torch.parallel.mesh import pmean_

    grads = [[torch.zeros_like(p) for p in opt.params] for opt in optimizers]
    for g in grads:
        pmean_(g, group)
    dist.barrier(group=group)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        for g in grads:
            pmean_(g, group)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / (iters * len(grads))


def _env_leaves(runner_state):
    """The FF runner state's env tensors (obs, the Log state, the env state)."""
    import torch

    obs, log_state = runner_state[1]
    leaves = [obs, log_state.episode_returns, log_state.episode_lengths, log_state.timestep]
    leaves += [v for v in vars(log_state.env_state).values()]
    return [t.detach().cpu() for t in leaves if torch.is_tensor(t)]


def _sharded_rank(rank, world, tmp, specs, mesh_seeds, bars):
    """One rank of phase 6p: joins the gloo group through ``tmp``'s file
    store on cuda:0, runs each spec with its counts set to 0 just before and
    read just after, and saves what it got to ``tmp/rank{rank}.pt``."""
    import importlib

    import torch
    import torch.distributed as dist

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    from purejaxql_torch.core.config import compose
    from purejaxql_torch.parallel.mesh import init_distributed, make_mesh
    from purejaxql_torch.parallel.spmd import (
        local_config, make_train_spmd, make_train_spmd_resumable, make_train_spmd_seeds, train_segmented_spmd,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_distributed(backend="gloo", init_method=f"file://{tmp}/store", timeout_s=SHARDED_TIMEOUT_S)
    mesh = make_mesh(seed=mesh_seeds)
    group = mesh.get_group("env")
    counters = kernel_counters()
    results = {}

    def counted(fn, line_up=True):
        for f in counters.values():
            f.launches = 0
        if line_up:
            dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, {k: f.launches for k, f in counters.items() if f.launches}

    for spec in specs:
        name, module = spec[0], spec[3]
        config, updates = sharded_config(compose, spec, bars)
        make_train = importlib.import_module(f"purejaxql_torch.algo.{module}").make_train
        res = {"updates": updates}
        if name == "segmented":
            (whole, seg), wall, got = counted(lambda: (
                make_train_spmd_resumable(config, mesh)(),
                train_segmented_spmd(config, mesh, SHARDED_SEGMENTS)))
            ws, ss = _rank_state(whole["runner_state"][0]), _rank_state(seg["runner_state"][0])
            we, se = _env_leaves(whole["runner_state"]), _env_leaves(seg["runner_state"])
            res.update(segment_gap=max([(ws[k] - ss[k]).abs().max().item() for k in ws]
                                       + [(a.double() - b.double()).abs().max().item() for a, b in zip(we, se)]),
                       train_state=seg["runner_state"][0], metrics=seg["metrics"])
        elif name == "seeds":
            out, wall, got = counted(lambda: make_train_spmd_seeds(config, mesh, make_train=make_train)())
            res.update(train_state=out["train_state"], metrics=out["metrics"],
                       seed_rows=out["state_dict"]["Dense_0.weight"].cpu())
        elif name == "nccl":
            # every rank makes the group; rank 0 alone trains on it while
            # the others wait at the barrier after it
            nccl = dist.new_group([0], backend="nccl")
            if rank != 0:
                dist.barrier()
                continue
            out, wall, got = counted(lambda: make_train(local_config(config, 1), group=nccl)(), line_up=False)
            res.update(train_state=out["runner_state"][0], metrics=out["metrics"])
        else:
            out, wall, got = counted(lambda: make_train_spmd(config, mesh, make_train=make_train)())
            res.update(train_state=out["train_state"], metrics=out["metrics"])
        train_state = res.pop("train_state")
        states = list(train_state.values()) if isinstance(train_state, dict) else [train_state]
        optimizers = [s.optimizer for s in states]
        res.update(
            wall=wall, launches=got, timesteps=states[0].timesteps, state=_rank_state(train_state),
            metrics={k: v.detach().cpu() for k, v in res["metrics"].items()},
            allreduce_ms=_allreduce_ms(optimizers, nccl if name == "nccl" else group),
            n_params=[sum(p.numel() for p in opt.params) for opt in optimizers],
        )
        if name == "nccl":
            dist.barrier()
        results[name] = res
    torch.save(results, os.path.join(tmp, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def _spawn_ranks(world, tmp, specs, mesh_seeds, bars, deadline_s):
    """Start ``world`` ranks of ``_sharded_rank``, wait for them within
    ``deadline_s`` (a failed rank ends them all with its error), and return
    their results."""
    import shutil

    import torch
    import torch.multiprocessing as mp

    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    ctx = mp.start_processes(_sharded_rank, args=(world, tmp, specs, mesh_seeds, bars), nprocs=world, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + deadline_s
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            fail(f"phase 6p: {world} ranks still running after {deadline_s} s")
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(world)]


def sharded_phase(compose, counters, save_path, card, bars=False):
    """Phase 6p, the sharded trainers (parallel/spmd.py) at the YAMLs' full
    width (global NUM_ENVS), SHARDED_WORLD ranks of one gloo group on cuda:0
    started once for every run, then a (2, 2) mesh of 4 ranks. Each run: the
    global timestep counter, the parameters and batch statistics bit-equal
    across the ranks (the largest gap printed, 0.0), finite metrics, each
    rank's launches against the single-process formula at its local shapes,
    the wall, per-rank and aggregate env-steps/s beside one process's rate
    on the same global config in this call (run here after the ranks end),
    and one gradient all-reduce's mean time. gloo stages a CUDA tensor's
    all-reduce through the host on one card: its times say nothing of NCCL
    across cards. Returns the launches of the phase's runs over every rank."""
    import importlib

    import numpy as np
    import torch

    from purejaxql_torch.parallel.spmd import local_config

    t_phase = time.perf_counter()
    total = {k: 0 for k in counters}
    deadline = 1800 if bars else 600
    ranks2 = _spawn_ranks(SHARDED_WORLD, os.path.join(save_path, "sharded2"), SHARDED_RUNS, 1, bars, deadline)
    ranks4 = _spawn_ranks(4, os.path.join(save_path, "sharded4"), SHARDED_SEED_RUNS, 2, bars, deadline)

    def check_ranks(spec, ranks, n_env_shards, single=None):
        name = spec[0]
        config, updates = sharded_config(compose, spec, bars)
        world = len(ranks)
        local = local_config(config, n_env_shards)
        expected = {k: v for k, v in sharded_expected(name, local, updates).items() if v}
        results = [r[name] for r in ranks]
        gap = 0.0
        for res in results:
            check(res["timesteps"] == config["TOTAL_TIMESTEPS"],
                  f"6p {name}: {res['timesteps']} env steps, expected {config['TOTAL_TIMESTEPS']}")
            check(res["launches"] == expected, f"6p {name}: launches {res['launches']}, expected {expected}")
            for k, v in res["metrics"].items():
                check(bool(torch.isfinite(v.double()).all()), f"6p {name}: non-finite metric {k}")
            for k, v in res["state"].items():
                check(bool(torch.isfinite(v.double()).all()), f"6p {name}: non-finite {k}")
            for k, v in res["launches"].items():
                total[k] += v
        for start in range(0, world, n_env_shards):  # each seed row's ranks
            row = results[start:start + n_env_shards]
            for res in row[1:]:
                gap = max(gap, max((res["state"][k].double() - row[0]["state"][k].double()).abs().max().item()
                                   for k in res["state"]))
        check(gap == 0.0, f"6p {name}: the replicas differ by {gap}")
        wall = max(r["wall"] for r in results)
        steps = config["TOTAL_TIMESTEPS"]  # a seed row's
        line = (f"6p {name} ({world} rank{'s' if world > 1 else ''} on {card}): {steps} env steps "
                f"{'a seed row ' if world > n_env_shards else ''}in {wall:.2f} s wall, per rank "
                f"{[round(steps / n_env_shards / r['wall']) for r in results]} env-steps/s, aggregate "
                f"{steps * world / n_env_shards / wall:.0f}")
        if single is not None:
            line += f"; one process {single[0]:.0f} env-steps/s ({single[1]:.2f} s)"
        line += (f"; replicas' largest gap {gap}; launches a rank {results[0]['launches']} (formula {expected}); "
                 f"one gradient all-reduce {np.mean([r['allreduce_ms'] for r in results]):.3f} ms "
                 f"({' and '.join(map(str, results[0]['n_params']))} floats)")
        print(line)
        return results

    def one_process(spec):
        """The same global config in this process, no group."""
        config, _ = sharded_config(compose, spec, bars)
        make_train = importlib.import_module(f"purejaxql_torch.algo.{spec[3]}").make_train
        for f in counters.values():
            f.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        make_train(config)()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return config["TOTAL_TIMESTEPS"] / wall, wall

    for spec in SHARDED_RUNS:
        name = spec[0]
        single = one_process(spec) if name in SHARDED_SINGLE else None
        results = check_ranks(spec, ranks2[:1] if name == "nccl" else ranks2, 1 if name == "nccl" else SHARDED_WORLD,
                              single)
        if name == SHARDED_GATE_RUN:
            last10 = float(results[0]["metrics"]["returned_episode_returns"][-10:].mean())
            print(f"6p {name}: mean of the last 10 returned_episode_returns {last10:.2f} "
                  f"(tests/test_pqn_train.py::test_cartpole_learns's bar > {SHARDED_GATE}, "
                  f"{'held' if bars else 'not held: --learning-bars holds it'})")
            if bars:
                check(last10 > SHARDED_GATE, f"6p {name} did not learn: {last10} <= {SHARDED_GATE}")
        if name == "segmented":
            gap = max(r["segment_gap"] for r in results)
            print(f"6p segmented: {SHARDED_SEGMENTS} segments against one resumable run, params and env states "
                  f"largest gap {gap}")
            check(gap == 0.0, f"6p segmented: not bit-equal to the resumable run ({gap})")
    for spec in SHARDED_SEED_RUNS:
        results = check_ranks(spec, ranks4, 2)
        rows = results[0]["seed_rows"]
        check(all(torch.equal(r["seed_rows"], rows) for r in results), "6p seeds: the gathered rows differ by rank")
        check(rows.shape[0] == 2 and not torch.equal(rows[0], rows[1]), "6p seeds: the seed rows' params are equal")
        for i, r in enumerate(results):
            check(torch.equal(r["state"]["Dense_0.weight"], rows[i // 2]), f"6p seeds: rank {i} is not its row")
        print(f"6p seeds: a (2, 2) mesh, each seed row's params its own (Dense_0 rows differ by "
              f"{(rows[0] - rows[1]).abs().max().item():.4g}), each row's 2 ranks bit-equal")
    launched = {k: v for k, v in total.items() if v}
    print(f"phase 6p (sharded trainers): {time.perf_counter() - t_phase:.1f} s wall; launches over the ranks "
          f"{launched}")
    return total


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Drive the PyTorch port on one GPU.")
    ap.add_argument("--learning-bars", action="store_true",
                    help="train the gated runs for their JAX tests' lengths and hold their bars")
    bars = ap.parse_args().learning_bars
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs one GPU")
    try:
        from purejaxql_torch import cli
        from purejaxql_torch.core.checkpoint import load_params
        from purejaxql_torch.core.config import compose
        from purejaxql_torch.envs import make as make_env
        from purejaxql_torch.envs import wrappers
        from purejaxql_torch.envs.classic.pendulum import PendulumParams
        from purejaxql_torch.envs.minatar.breakout import start_state
        from purejaxql_torch.models.cnn import CNNQNetwork
        from purejaxql_torch.models.qnet import QNetwork
        from purejaxql_torch.ops import asterix_rollout as ar
        from purejaxql_torch.ops import breakout_rollout as br
        from purejaxql_torch.ops import build
        from purejaxql_torch.ops import cartpole_rollout as cr
        from purejaxql_torch.ops import eps_greedy as eg
        from purejaxql_torch.ops import freeway_rollout as fr
        from purejaxql_torch.ops import gru_scan as gs
        from purejaxql_torch.ops import lambda_returns as lr
        from purejaxql_torch.ops import minatar_rollout
        from purejaxql_torch.ops import pendulum_rollout as pr
        from purejaxql_torch.ops import seaquest_rollout as sq
        from purejaxql_torch.ops import space_invaders_rollout as sr
        from purejaxql_torch.ops.fast_rnn import fast_rnn_train_forward
        from purejaxql_torch.ops.minatar_rollout import minatar_weights
    except ImportError as e:
        fail(f"cannot import purejaxql_torch ({e}): run from the root of a checkout")
    import numpy as np

    def gated(full_steps, steps_per_update, short_updates=GATE_SHORT_UPDATES):
        """A gated run's env steps: its bar's length with --learning-bars,
        else ``short_updates`` updates."""
        return full_steps if bars else short_updates * steps_per_update

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root = os.path.dirname(os.path.abspath(__file__))
    counters = kernel_counters()

    # ---- 1. the card -------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip()
    print(card)
    nvcc_version = subprocess.run(
        [build.nvcc_path(), "--version"], capture_output=True, text=True, timeout=60
    ).stdout.strip().splitlines()[-1]
    print(
        f"torch {torch.__version__} cuda {torch.version.cuda} nvcc: {nvcc_version} "
        f"device: {torch.cuda.get_device_name(0)} count: {torch.cuda.device_count()}"
    )

    # ---- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    try:
        per_source = build.build(SOURCES)
    except RuntimeError as e:
        fail(f"build failed: {e}")
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.1f} s wall, per source {json.dumps(per_source)}")
    for name in SOURCES:
        log = build.library_path(name).with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}")

    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(0)
    errors = {}

    # ---- 3a. lambda returns, both forms, vs plain ------------------------------
    lam_inputs = {}
    lam_forms = {
        "lambda_returns": (lr.lambda_returns, lr.lambda_returns_plain),
        "lambda_returns_closure": (lr.lambda_returns_closure, lr.lambda_returns_closure_plain),
    }
    for T, E in LAMBDA_SHAPES:
        rew = rng.randn(T, E).astype(np.float32)
        done = (rng.rand(T, E) < 0.15).astype(np.float32)
        maxq = rng.randn(T, E).astype(np.float32)
        lastq = rng.randn(E).astype(np.float32)
        lam_inputs[(T, E)] = [torch.tensor(a, device=dev) for a in (lastq, rew, done, maxq)]
        # a NaN, +inf and -inf in a row of max_qs, +inf and -inf in one of rewards
        maxq[T // 2, : min(E, 3)] = [np.nan, np.inf, -np.inf][: min(E, 3)]
        rew[T // 3, -min(E, 2):] = [np.inf, -np.inf][: min(E, 2)]
        nonfinite = [torch.tensor(a, device=dev) for a in (lastq, rew, done, maxq)]
        for name, (kernel, plain) in lam_forms.items():
            err, err_nonfinite = (max_abs_err(kernel(*args, 0.99, 0.95), plain(*args, 0.99, 0.95))
                                  for args in (lam_inputs[(T, E)], nonfinite))
            print(f"{name} ({T},{E}): max|kernel - plain| = {err:.3g}, with NaN and inf rows "
                  f"{err_nonfinite:.3g} (tolerance 1e-5)")
            check(max(err, err_nonfinite) <= 1e-5,
                  f"{name} disagrees with its plain twin at ({T},{E}): {err}, with NaN and inf rows {err_nonfinite}")
            errors[name] = max(errors.get(name, 0.0), err, err_nonfinite)
    for T, E in LAMBDA_SHAPES:
        plan = lr.lambda_plan(T, E)
        print(f"lambda_plan({T}, {E}): tile {plan.tile}, {plan.blocks} blocks, chunk {plan.chunk}, "
              f"{plan.stages} stages, {plan.smem_bytes} B")

    # ---- 3b. CartPole rollout vs plain, PRNG off and on --------------------------
    H, A = 256, 2
    gen = torch.Generator().manual_seed(0)
    net = QNetwork(4, A, hidden_size=H, num_layers=2, generator=gen).to(dev)
    weights = cr.cartpole_weights(net)

    def reset_states(B, seed):
        g = torch.Generator().manual_seed(seed)
        stf = (torch.rand(4, B, generator=g) * 0.1 - 0.05).to(dev)
        return stf.contiguous(), torch.zeros(1, B, dtype=torch.int32, device=dev)

    names = ("obs", "act", "rew", "done", "q", "final_obs", "stf", "sti")
    roll_err = 0.0
    for B in (32, 128):
        stf0, sti0 = reset_states(B, B)
        for use_prng in (False, True):
            got = cr.cartpole_rollout(1234, 0.1, weights, stf0, sti0, 64, use_prng=use_prng)
            want = cr.cartpole_rollout_plain(1234, 0.1, weights, stf0, sti0, 64, use_prng=use_prng)
            torch.cuda.synchronize()
            g, w = dict(zip(names, got)), dict(zip(names, want))
            mism = (g["act"] != w["act"]).nonzero()
            if len(mism):
                t, b = mism[0].tolist()
                gap = (w["q"][t, b, 0] - w["q"][t, b, 1]).abs().item()
                fail(
                    f"rollout B={B} prng={use_prng}: action differs first at t={t} env={b}; "
                    f"plain q-gap there {gap:.3g}, kernel q {g['q'][t, b].tolist()} plain q {w['q'][t, b].tolist()}"
                )
            for k in ("rew", "done", "sti"):
                check(torch.equal(g[k], w[k]), f"rollout B={B} prng={use_prng}: {k} differs")
            errs = {k: (g[k] - w[k]).abs().max().item() for k in ("obs", "final_obs", "stf", "q")}
            print(f"cartpole_rollout B={B} T=64 prng={use_prng}: actions/rewards/dones equal, max|err| {errs}")
            for k in ("obs", "final_obs", "stf"):
                check(errs[k] <= 1e-5, f"rollout B={B} prng={use_prng}: {k} err {errs[k]} > 1e-5")
            check(errs["q"] <= 1e-4, f"rollout B={B} prng={use_prng}: q err {errs['q']} > 1e-4")
            if B == 32:
                roll_err = max(roll_err, max(errs.values()))
    # each plan (the trainer's two shapes and the ragged ones) with its
    # registers, spills and the clusters the card places at once; the ragged
    # shapes reset every env, PRNG off and on
    cp_resources = kernel_resources(build.library_path("cartpole_rollout").with_suffix(".log").read_text())
    for cT, cB, cH, c_max in ((64, 32, H, 500), (64, 128, H, 500), *CARTPOLE_RAGGED):
        plan = cr.cartpole_plan(cB, cH)
        # the template instance it launches: <resident, G, a lane's units (8 at H 256, else 0)>
        nu = 8 if plan.resident and cH == 256 else 0
        c_res = named_instance(cp_resources, f"cartpole_rollout_kernelILb{int(plan.resident)}ELi{plan.group}ELi{nu}E")
        placed = cr.active_clusters(plan, cH)
        print(f"cartpole_rollout (B, H) = {(cB, cH)}: plan C {plan.cluster}, G {plan.group}, {plan.clusters} "
              f"cluster(s), {plan.units} units a CTA, W2 slice resident {plan.resident}, shared bytes "
              f"{plan.smem_bytes}, {placed} clusters placed at once; registers / spill bytes {c_res[0]} / {c_res[1]}")
        check(c_res[0] is not None, f"cartpole_rollout: no register count for the plan at {(cB, cH)}")
        if c_max == 500:
            check(placed >= plan.clusters, f"cartpole_rollout: the card places {placed} of {plan.clusters} clusters")
            continue
        rnet = QNetwork(4, A, hidden_size=cH, num_layers=2, generator=torch.Generator().manual_seed(cB + cH)).to(dev)
        r = np.random.RandomState(cB)
        stf0 = r.uniform(-0.05, 0.05, (4, cB)).astype(np.float32)
        stf0[:, : cB // 4] *= 40  # some envs start near or past the bounds
        stf0 = torch.tensor(stf0, device=dev)
        sti0 = torch.tensor(r.randint(0, 3, (1, cB)).astype(np.int32), device=dev)
        for use_prng in (False, True):
            got = cr.cartpole_rollout(55, 0.2, cr.cartpole_weights(rnet), stf0, sti0, cT, use_prng=use_prng,
                                      max_steps=c_max)
            want = cr.cartpole_rollout_plain(55, 0.2, cr.cartpole_weights(rnet), stf0, sti0, cT,
                                             use_prng=use_prng, max_steps=c_max)
            torch.cuda.synchronize()
            g, w = dict(zip(names, got)), dict(zip(names, want))
            for k in ("act", "rew", "done", "sti"):
                check(torch.equal(g[k], w[k]), f"cartpole_rollout {(cT, cB, cH)} prng={use_prng}: {k} differs")
            errs = {k: (g[k] - w[k]).abs().max().item() for k in ("obs", "final_obs", "stf", "q")}
            n_done = int(w["done"].sum())
            print(f"cartpole_rollout T={cT} B={cB} H={cH} max_steps={c_max} prng={use_prng}: actions/rewards/"
                  f"dones/time equal ({n_done} resets), max|err| {errs}")
            check(max(errs[k] for k in ("obs", "final_obs", "stf")) <= 1e-5 and errs["q"] <= 1e-4,
                  f"cartpole_rollout {(cT, cB, cH)} prng={use_prng}: {errs} over 1e-5 / 1e-4")
            check(n_done >= 4 * cB, "cartpole_rollout: fewer resets than the time limit forces")
    # a head bias of [0, NaN]: every Q-row holds a NaN at index 1, which
    # torch.argmax and jnp.argmax take as the maximum
    stf0, sti0 = reset_states(37, 37)
    nan_weights = weights[:9] + (torch.tensor([0.0, float("nan")], device=dev),)
    got = cr.cartpole_rollout(9, 0.0, nan_weights, stf0, sti0, 8, use_prng=False)
    want = cr.cartpole_rollout_plain(9, 0.0, nan_weights, stf0, sti0, 8, use_prng=False)
    torch.cuda.synchronize()
    check(bool((got[1] == 1).all()) and all(torch.equal(got[i], want[i]) for i in (1, 2, 3, 7))
          and bool(got[4][..., 1].isnan().all()), "cartpole_rollout: a NaN Q-value did not take the greedy action")
    print("cartpole_rollout with a NaN in every Q-row at index 1: action 1 on every env and step, as the twin")
    errors["cartpole_rollout"] = roll_err

    # ---- 3c. Breakout rollout vs plain, PRNG off and on ------------------------
    BB, BT, BH, BA = 128, 32, 128, 3
    bnet = CNNQNetwork((10, 10, 4), BA, hidden_size=BH, generator=torch.Generator().manual_seed(1)).to(dev)
    bweights = minatar_weights(bnet)

    def breakout_states(B, seed):
        """Half the envs at an episode's start, half on random boards (any
        ball position above the paddle row, direction and time, thinned
        walls, strike latches, a quarter of them one brick from a respawn),
        so that the comparison meets every rule of the step."""
        r = np.random.RandomState(seed)
        st, brick = br.state_matrix_from_breakout(start_state(torch.tensor(r.randint(0, 2, B), dtype=torch.int32)))
        n = B - B // 2
        by, bx, d = r.randint(0, 9, n), r.randint(0, 10, n), r.randint(0, 4, n)
        ly = np.clip(by - np.array([-1, -1, 1, 1])[d], 0, 9)
        lx = np.clip(bx - np.array([-1, 1, 1, -1])[d], 0, 9)
        rows = [by, bx, d, r.randint(0, 10, n), r.randint(0, 2, n), ly, lx, r.randint(0, 1000, n)]
        st[:, B // 2:] = torch.tensor(np.stack(rows), dtype=torch.int32)
        walls = (r.rand(10, 10, n) < 0.6) & (np.arange(10) >= 1)[:, None, None] & (np.arange(10) <= 3)[:, None, None]
        walls[:, :, : n // 4] = False
        walls[2, 5, : n // 4] = True
        brick[:, :, B // 2:] = torch.tensor(walls, dtype=torch.int32)
        return st.to(dev).contiguous(), brick.to(dev).contiguous()

    st0, brick0 = breakout_states(BB, 3)
    q_err = 0.0
    breakout_resets = {}
    for use_prng in (False, True):
        err, n_done, n_rew, n_random, _ = compare_minatar(
            "breakout_rollout", br.breakout_rollout, br.breakout_rollout_plain, bweights, (st0, brick0), BT, use_prng
        )
        breakout_resets[use_prng] = n_done
        print(
            f"breakout_rollout B={BB} T={BT} prng={use_prng}: obs/actions/rewards/dones/state/bricks equal "
            f"({n_done} resets, {n_rew:.0f} bricks scored, {n_random} non-greedy actions), "
            f"max|q err| {err:.3g} (tolerance 1e-4)"
        )
        check(n_done > 0, "breakout_rollout: no env reset in the comparison")
        q_err = max(q_err, err)
    errors["breakout_rollout"] = q_err

    # ---- 3d. Asterix, Freeway, SpaceInvaders and Seaquest rollouts vs plain, PRNG off and on --
    games = {  # kernel, twin, states, channels, actions, what a reward is
        "asterix_rollout": (ar.asterix_rollout, ar.asterix_rollout_plain, asterix_states, 4, 5, "gold"),
        "freeway_rollout": (fr.freeway_rollout, fr.freeway_rollout_plain, freeway_states, 7, 3, "crossings"),
        "space_invaders_rollout": (
            sr.space_invaders_rollout, sr.space_invaders_rollout_plain, space_invaders_states, 6, 4, "kills",
        ),
        "seaquest_rollout": (sq.seaquest_rollout, sq.seaquest_rollout_plain, seaquest_states, 10, 6, "kills and cash-ins"),
    }
    game_inputs = {}
    for i, (name, (kernel, plain, make_states, gC, gA, scores)) in enumerate(games.items()):
        net = CNNQNetwork((10, 10, gC), gA, hidden_size=BH, generator=torch.Generator().manual_seed(2 + i)).to(dev)
        gweights = minatar_weights(net)
        gstates = tuple(x.to(dev) for x in make_states(BB, 3 + i))
        game_inputs[name] = (gweights, gstates)
        q_err = 0.0
        for use_prng in (False, True):
            err, n_done, rew, n_random, _ = compare_minatar(name, kernel, plain, gweights, gstates, BT, use_prng)
            print(
                f"{name} B={BB} T={BT} prng={use_prng}: obs/actions/rewards/dones/state equal "
                f"({n_done} resets, {rew:.0f} {scores}, {n_random} non-greedy actions), "
                f"max|q err| {err:.3g} (tolerance 1e-4)"
            )
            check(n_done > 0, f"{name}: no env reset in the comparison")
            check(rew > 0 or name == "freeway_rollout", f"{name}: nothing scored in the comparison")
            q_err = max(q_err, err)
        errors[name] = q_err
    # Seaquest at a small shape whose time limit resets every env four times
    sq_small = tuple(x.to(dev) for x in seaquest_states(16, 11))
    for use_prng in (False, True):
        err, n_done, rew, n_random, _ = compare_minatar(
            "seaquest_rollout", sq.seaquest_rollout, sq.seaquest_rollout_plain, game_inputs["seaquest_rollout"][0],
            sq_small, 40, use_prng, max_steps=9,
        )
        print(
            f"seaquest_rollout B=16 T=40 max_steps=9 prng={use_prng}: obs/actions/rewards/dones/state equal "
            f"({n_done} resets, {rew:.1f} reward, {n_random} non-greedy actions), max|q err| {err:.3g} "
            f"(tolerance 1e-4)"
        )
        check(n_done >= 4 * 16, "seaquest_rollout: fewer resets than the time limit forces")
        errors["seaquest_rollout"] = max(errors["seaquest_rollout"], err)
    # Seaquest's cash-ins: the trainer-shape states with six divers on board,
    # one row under the surface and not surfaced, oxygen 1-128; random actions
    # (eps 1) take about a sixth of the envs up, to a reward of kills +
    # oxygen * 0.1f
    cash = sq.seaquest_from_state_matrix(game_inputs["seaquest_rollout"][1][0].cpu())
    cash.divers[:], cash.sub_y[:] = 6, 1
    cash.oxygen[:] = torch.arange(BB) % 199 + 1  # mostly not a multiple of 10: a reward that is not whole
    cash.surfaced, cash.terminal = torch.zeros_like(cash.surfaced), torch.zeros_like(cash.terminal)
    err, n_done, rew, n_random, n_cash = compare_minatar(
        "seaquest_rollout", sq.seaquest_rollout, sq.seaquest_rollout_plain, game_inputs["seaquest_rollout"][0],
        (sq.state_matrix_from_seaquest(cash).to(dev),), 2, True, eps=1.0,
    )
    print(f"seaquest_rollout B={BB} T=2 six divers under the surface: obs/actions/rewards/dones/state equal "
          f"({n_cash} cash-ins, {rew:.1f} reward), max|q err| {err:.3g} (tolerance 1e-4)")
    check(n_cash > 0, "seaquest_rollout: no cash-in in the cash-in check")
    errors["seaquest_rollout"] = max(errors["seaquest_rollout"], err)

    # the kernels on the cluster CNN (all five MinAtar games): each plan with
    # its registers and spills and the clusters the card places at once, and
    # a ragged shape (clusters with CTAs past the last env, H 256) that
    # resets every env
    games["breakout_rollout"] = (br.breakout_rollout, br.breakout_rollout_plain, breakout_states, 4, BA, "bricks")
    game_inputs["breakout_rollout"] = (bweights, (st0, brick0))
    rT, rB, rH, r_max = CLUSTER_RAGGED
    for i, (name, plan_fn) in enumerate((
        ("asterix_rollout", ar.asterix_plan), ("freeway_rollout", fr.freeway_plan),
        ("seaquest_rollout", sq.seaquest_plan), ("breakout_rollout", br.breakout_plan),
        ("space_invaders_rollout", sr.space_invaders_plan),
    )):
        kernel, plain, make_states, gC, gA, _ = games[name]
        resources = kernel_resources(build.library_path(name).with_suffix(".log").read_text())
        for plan_shape in ((BB, BH), (rB, rH)):
            plan = plan_fn(*plan_shape)
            # the template instance it launches: <C>
            regs, spill = named_instance(resources, f"{name}_kernelILi{plan.cluster}E")
            print(f"{name} (B, H) = {plan_shape}: plan C {plan.cluster}, {plan.clusters} cluster(s), "
                  f"{plan.columns} dense columns a CTA (the weight on chip), {plan.chunks} chunks, {plan.threads} "
                  f"threads, shared bytes {plan.smem_bytes}, {minatar_rollout.active_clusters(name, plan)} "
                  f"clusters placed at once; registers / spill bytes {regs} / {spill}")
        rnet = CNNQNetwork((10, 10, gC), gA, hidden_size=rH, generator=torch.Generator().manual_seed(21 + i)).to(dev)
        r_states = tuple(x.to(dev) for x in make_states(rB, 21 + i))
        for use_prng in (False, True):
            err, n_done, rew, n_random, _ = compare_minatar(
                name, kernel, plain, minatar_weights(rnet), r_states, rT, use_prng, max_steps=r_max,
            )
            print(f"{name} B={rB} T={rT} H={rH} max_steps={r_max} prng={use_prng}: obs/actions/rewards/dones/"
                  f"state equal ({n_done} resets, {rew:.1f} reward, {n_random} non-greedy actions), max|q err| "
                  f"{err:.3g} (tolerance 1e-4)")
            check(n_done >= 2 * rB, f"{name}: fewer resets than the time limit forces")
            errors[name] = max(errors[name], err)
        # a NaN head bias on action 2 at eps 0: every Q-row holds a NaN there,
        # which torch.argmax and jnp.argmax take as the maximum
        nweights, nstates = game_inputs[name]
        bias = nweights[9].clone()
        bias[2] = float("nan")
        nweights = tuple(nweights[:9]) + (bias,)
        got = kernel(5, 0.0, nweights, *nstates, 4, use_prng=False)
        want = plain(5, 0.0, nweights, *nstates, 4, use_prng=False)
        torch.cuda.synchronize()
        check(bool((got[1] == 2).all()) and all(torch.equal(g, w) for i, (g, w) in enumerate(zip(got, want)) if i != 4)
              and bool(got[4][..., 2].isnan().all()), f"{name}: a NaN Q-value did not take the greedy action")
        print(f"{name} with a NaN in every Q-row at action 2: action 2 on every env and step, every output "
              f"but Q as the twin's")

    # ---- 3e. GRU scan kernels vs plain, and autograd through them ---------------
    # forward within 1e-5; backward within 1e-4 absolute and relative: the
    # kernels sum the products in another order than the twins' matmuls
    gru_resources = {
        name: kernel_resources(build.library_path(name).with_suffix(".log").read_text())
        for name in ("gru_scan_fwd", "gru_scan_bwd")
    }
    gru_inputs_by_shape = {}
    for i, shape in enumerate(GRU_SHAPES):
        xi, keep, h0, w_h, b_hn, g_y, g_hT = gru_inputs(*shape, 10 + i, dev)
        got = gs.gru_scan_fwd(xi, keep, h0, w_h, b_hn)
        want = gs.gru_scan_fwd_plain(xi, keep, h0, w_h, b_hn)
        torch.cuda.synchronize()
        f_err = max((g - w).abs().max().item() for g, w in zip(got, want))
        hprev = torch.cat([h0[None], want[0][:-1]])
        res = (keep, hprev, w_h, *want[1:])
        got = gs.gru_scan_bwd(*res, g_y, g_hT)
        want = gs.gru_scan_bwd_plain(*res, g_y, g_hT)
        torch.cuda.synchronize()
        b_err = max((g - w).abs().max().item() for g, w in zip(got, want))
        b_rel = max(((g - w).abs() / (1e-4 + 1e-4 * w.abs())).max().item() for g, w in zip(got, want))
        plan = gs.scan_plan(*shape[1:])
        # the template instance each kernel launches: <R, slice in shared memory, in registers>
        args = (plan.rows, plan.resident and not plan.registers, plan.registers)
        f_res = gru_instance(gru_resources["gru_scan_fwd"], "gru_scan_fwd_kernel", *args)
        b_res = gru_instance(gru_resources["gru_scan_bwd"], "gru_scan_bwd_kernel", *args)
        placed = [gs.active_clusters(k, plan) for k in ("gru_scan_fwd", "gru_scan_bwd")]
        print(
            f"gru_scan (T, B, H) = {shape}: plan C {plan.cluster}, U {plan.units}, R {plan.rows}, "
            f"{plan.clusters} cluster(s), placed at once fwd {placed[0]} bwd {placed[1]} "
            f"(waves {-(-plan.clusters // placed[0])} / {-(-plan.clusters // placed[1])}), "
            f"{plan.threads} threads, W_h resident {plan.resident}, "
            f"shared bytes fwd {plan.fwd_bytes} bwd {plan.bwd_bytes}, slice in registers {plan.registers}; "
            f"registers / spill bytes fwd {f_res[0]} / {f_res[1]}, bwd {b_res[0]} / {b_res[1]}; "
            f"forward max|err| {f_err:.3g} (tolerance 1e-5); backward max|err| {b_err:.3g}, "
            f"max |err| / (1e-4 + 1e-4 |plain|) {b_rel:.3g} (must be <= 1); resets {int((keep == 0).sum())}"
        )
        check(f_err <= 1e-5, f"gru_scan_fwd disagrees with its twin at {shape}: {f_err}")
        check(b_rel <= 1.0, f"gru_scan_bwd disagrees with its twin at {shape}: {b_err}")
        errors["gru_scan_fwd"] = max(errors.get("gru_scan_fwd", 0.0), f_err)
        errors["gru_scan_bwd"] = max(errors.get("gru_scan_bwd", 0.0), b_err)
        gru_inputs_by_shape[shape] = (xi, keep, h0, w_h, b_hn, g_y, g_hT, res)
    xi, keep, h0, w_h, b_hn = gru_inputs_by_shape[GRU_SHAPES[0]][:5]
    grads = []
    for use_kernel in (True, False):
        args = [a.clone().requires_grad_(i != 1) for i, a in enumerate((xi, keep, h0, w_h, b_hn))]
        h_T, y = gs.GRUScan.apply(*args) if use_kernel else (None, gs.gru_scan_fwd_plain(*args)[0])
        h_T = y[-1] if h_T is None else h_T
        (torch.sin(y).sum() + h_T.sum()).backward()
        grads.append([a.grad for i, a in enumerate(args) if i != 1])
    a_rel = max(((g - w).abs() / (1e-4 + 1e-4 * w.abs())).max().item() for g, w in zip(*grads))
    print(f"GRUScan autograd vs autograd through the plain loop (T 132, B 2, H 256): "
          f"max |err| / (1e-4 + 1e-4 |plain|) {a_rel:.3g} (must be <= 1)")
    check(a_rel <= 1.0, f"autograd through GRUScan disagrees with the plain loop: {a_rel}")

    # ---- 3e'. the GRU scan kernels with a seed axis ------------------------------
    # one launch for S seeds (a stacked W_h, seed-major rows) against the
    # seeded twins, forward within 1e-5, backward as above; and lane s bit
    # for bit against the unseeded launch on seed s's rows and weights
    seeded_gru = {}
    for i, (T, S, B, H) in enumerate(SEEDED_GRU_SHAPES):
        (xi, keep, h0, w_h, b_hn, g_y, g_hT), lanes = seeded_gru_inputs(T, S, B, H, 40 + i, dev)
        got = gs.gru_scan_fwd(xi, keep, h0, w_h, b_hn)
        want = gs.gru_scan_fwd_plain(xi, keep, h0, w_h, b_hn)
        torch.cuda.synchronize()
        f_err = max((g - w).abs().max().item() for g, w in zip(got, want))
        res = (keep, torch.cat([h0[None], got[0][:-1]]), w_h, *got[1:])
        got_b = gs.gru_scan_bwd(*res, g_y, g_hT)
        want_b = gs.gru_scan_bwd_plain(*res, g_y, g_hT)
        torch.cuda.synchronize()
        b_err = max((g - w).abs().max().item() for g, w in zip(got_b, want_b))
        b_rel = max(((g - w).abs() / (1e-4 + 1e-4 * w.abs())).max().item() for g, w in zip(got_b, want_b))
        lane_args, same = [], True
        for s_, (lxi, lkeep, lh0, lw, lb, lgy, lghT) in enumerate(lanes):
            rows = slice(s_ * B, (s_ + 1) * B)
            one = gs.gru_scan_fwd(lxi, lkeep, lh0, lw, lb)
            same &= all(torch.equal(a[:, rows], b) for a, b in zip(got, one))
            lres = (lkeep, torch.cat([lh0[None], one[0][:-1]]), lw, *one[1:])
            one_b = gs.gru_scan_bwd(*lres, lgy, lghT)
            same &= torch.equal(got_b[0][:, rows], one_b[0]) and torch.equal(got_b[1][rows], one_b[1])
            same &= torch.equal(got_b[2][s_], one_b[2]) and torch.equal(got_b[3][s_], one_b[3])
            lane_args.append(((lxi, lkeep, lh0, lw, lb), (*lres, lgy, lghT)))
        plan = gs.scan_plan(B, H)
        print(f"gru_scan seeded (T, S, B, H) = {(T, S, B, H)}: {S * plan.clusters} cluster(s) in one launch "
              f"(C {plan.cluster}, R {plan.rows}); forward max|err| {f_err:.3g} (tolerance 1e-5), backward "
              f"max|err| {b_err:.3g}, max |err| / (1e-4 + 1e-4 |plain|) {b_rel:.3g} (must be <= 1); dW_h "
              f"{tuple(got_b[2].shape)}; each lane equal to the unseeded launch on its seed, bit for bit: {same}")
        check(f_err <= 1e-5, f"seeded gru_scan_fwd disagrees with its twin at {(T, S, B, H)}: {f_err}")
        check(b_rel <= 1.0, f"seeded gru_scan_bwd disagrees with its twin at {(T, S, B, H)}: {b_err}")
        check(same, f"seeded gru_scan at {(T, S, B, H)}: a lane differs from the unseeded launch on its seed")
        errors["gru_scan_fwd"] = max(errors["gru_scan_fwd"], f_err)
        errors["gru_scan_bwd"] = max(errors["gru_scan_bwd"], b_err)
        seeded_gru[(T, S, B, H)] = ((xi, keep, h0, w_h, b_hn), (*res, g_y, g_hT), lane_args)

    # ---- 3f. the Pendulum actor-critic rollout vs plain, PRNG off and on --------
    # done and time equal; every float within 1e-4 (the MLPs sum in another
    # order than the twin's matmuls, and the pendulum carries the gap along)
    pend_names = ("obs", "u", "greedy", "value", "reward", "done", "final_obs", "stf", "sti")
    pend_inputs = {}
    pend_resources = kernel_resources(build.library_path("pendulum_ac_rollout").with_suffix(".log").read_text())
    for pT, pB, pH, p_max in PENDULUM_SHAPES:
        (aw, cw), stf, sti = pendulum_inputs(pB, pH, pB, dev)
        pend_inputs[(pT, pB, pH)] = (aw, cw, stf, sti)
        plan = pr.pendulum_plan(pB, pH)
        # the template instance it launches: <resident, G, a lane's units (8 at H 256, else 0)>
        nu = 8 if plan.resident and pH == 256 else 0
        p_res = named_instance(pend_resources, f"pendulum_ac_rollout_kernelILb{int(plan.resident)}ELi{plan.group}ELi{nu}E")
        print(f"pendulum_ac_rollout (B, H) = {(pB, pH)}: plan C {plan.cluster}, G {plan.group}, {plan.clusters} "
              f"cluster(s), {plan.units} units a CTA, W2 slices resident {plan.resident}, {plan.threads} threads, "
              f"shared bytes {plan.smem_bytes}; registers / spill bytes {p_res[0]} / {p_res[1]}")
        for use_prng in (False, True):
            got = pr.pendulum_ac_rollout(11, 0.8, aw, cw, stf, sti, pT, use_prng=use_prng, max_steps=p_max)
            want = pr.pendulum_rollout_plain(11, 0.8, aw, cw, stf, sti, pT, use_prng=use_prng, max_steps=p_max)
            torch.cuda.synchronize()
            for name, g, w in zip(pend_names, got, want):
                check(g.shape == w.shape and g.dtype == w.dtype, f"pendulum_ac_rollout: {name} shape or dtype")
            for name in ("done", "sti"):
                i = pend_names.index(name)
                check(torch.equal(got[i], want[i]), f"pendulum_ac_rollout T={pT} B={pB} prng={use_prng}: {name} differs")
            errs = {n: (g - w).abs().max().item() for n, g, w in zip(pend_names, got, want) if n not in ("done", "sti")}
            resets, clipped = int(want[5].sum()), (want[1].abs() == 2).float().mean().item()
            print(f"pendulum_ac_rollout T={pT} B={pB} H={pH} max_steps={p_max} prng={use_prng}: done/time equal "
                  f"({resets} resets, {100 * clipped:.1f} % of actions clipped), max|err| "
                  f"{ {k: float(f'{v:.3g}') for k, v in errs.items()} } (tolerance 1e-4)")
            check(resets > 0, "pendulum_ac_rollout: no env reset in the comparison")
            check(max(errs.values()) <= 1e-4, f"pendulum_ac_rollout disagrees with its twin: {errs}")
            errors["pendulum_ac_rollout"] = max(errors.get("pendulum_ac_rollout", 0.0), max(errs.values()))

    # ---- 3g. the epsilon-greedy kernel vs plain: bit for bit ----------------------
    def eps_q(E, A, seed):
        """Half-integer Q-values (ties in most rows), row 0 tied for the
        maximum at two indices, row 1 holding a NaN."""
        r = np.random.RandomState(seed)
        qv = (np.round(r.randn(E, A) * 2) / 2).astype(np.float32)
        qv[0, [A // 2, A - 1]] = 9.0
        qv[1, A - 1] = np.nan
        return torch.tensor(qv, device=dev)

    eps_inputs = {}
    for E, EA in EPS_GREEDY_SHAPES:
        qv = eps_inputs[(E, EA)] = eps_q(E, EA, E + EA)
        n_random = 0
        for eps in (0.0, 0.3, 1.0):
            for seed in (3, 2**62 + 5):
                got, want = eg.eps_greedy(seed, qv, eps), eg.eps_greedy_plain(seed, qv, eps)
                torch.cuda.synchronize()
                check(got.dtype == torch.int64 and torch.equal(got, want),
                      f"eps_greedy ({E}, {EA}) eps {eps} seed {seed}: kernel and twin differ")
                n_random += int((got != qv.argmax(-1)).sum())
        check(int(eg.eps_greedy(3, qv, 0.0)[0]) == EA // 2 and int(eg.eps_greedy(3, qv, 0.0)[1]) == EA - 1,
              "eps_greedy: the tie or the NaN row took the wrong greedy action")
        print(f"eps_greedy (E, A) = ({E}, {EA}): actions equal to the twin's at eps 0, 0.3, 1 and two seeds "
              f"({n_random} non-greedy), the tie row takes index {EA // 2}, the NaN row index {EA - 1}")
    # edge rows: -0.0 against +0.0, NaNs of four payloads (the first wins), a
    # NaN after +inf, all -inf, all NaN, +inf twice; at A 34 and 65 (three
    # elements a lane)
    for EA in (34, 65):
        edges = eps_edge_rows(EA)
        qv = torch.tensor(np.concatenate([edges, np.random.RandomState(EA).randn(64, EA).astype(np.float32)]),
                          device=dev)
        want_greedy = torch.tensor(edges).argmax(-1)
        for eps in (0.0, 0.3):
            got = eg.eps_greedy(17, qv, eps)
            torch.cuda.synchronize()
            check(torch.equal(got, eg.eps_greedy_plain(17, qv, eps)), f"eps_greedy edge rows A {EA} eps {eps}: differs")
        check(torch.equal(eg.eps_greedy(17, qv, 0.0)[: len(edges)].cpu(), want_greedy),
              f"eps_greedy edge rows A {EA}: not torch.argmax's choice on the CPU")
        print(f"eps_greedy edge rows at A {EA}: equal to the twin at eps 0 and 0.3, greedy "
              f"{want_greedy.tolist()} as torch.argmax on the CPU")
    errors["eps_greedy"] = 0.0

    # ---- 4. PRNG-on statistics -----------------------------------------------
    B, T = 128, 64
    stf0, sti0 = reset_states(B, 7)
    obs, act, rew, done, q, _, _, _ = cr.cartpole_rollout(99, 0.3, weights, stf0, sti0, T)
    p_random = (act.long() != q.argmax(-1)).float().mean().item()
    print(f"P(act != greedy) at eps 0.3, A=2: {p_random:.4f} (expect 0.15)")
    check(abs(p_random - 0.15) < 0.02, f"P(act != greedy) = {p_random}")
    obs1 = cr.cartpole_rollout(5, 0.0, weights, stf0, sti0, T, max_steps=1)[0]
    draws = obs1[1:]  # every step resets at max_steps=1
    lo, hi, mean = draws.min().item(), draws.max().item(), draws.mean().item()
    print(f"reset draws: min {lo:.5f} max {hi:.5f} mean {mean:.5f} std {draws.std().item():.5f} (U(-0.05,0.05): std 0.02887)")
    check(-0.05 <= lo and hi <= 0.05 and abs(mean) < 0.002, "reset draws out of U(-0.05, 0.05)")
    obs2 = cr.cartpole_rollout(6, 0.0, weights, stf0, sti0, T, max_steps=1)[0]
    act2 = cr.cartpole_rollout(100, 0.3, weights, stf0, sti0, T)[1]
    check(not torch.equal(obs1, obs2) and not torch.equal(act, act2), "different seeds gave the same stream")
    print("cartpole: different seeds give different streams")

    _, bact, _, _, bq, _, _, _ = br.breakout_rollout(99, 0.3, bweights, st0, brick0, BT)
    p_random = (bact.long() != bq.argmax(-1)).float().mean().item()
    print(f"P(act != greedy) at eps 0.3, A=3: {p_random:.4f} (expect 0.2)")
    check(abs(p_random - 0.2) < 0.02, f"breakout P(act != greedy) = {p_random}")
    bobs1 = br.breakout_rollout(5, 0.0, bweights, st0, brick0, BT, max_steps=1)[0]
    ball = bobs1[1:, :, :, :, 1]  # every step resets at max_steps=1: the ball at row 3
    check(bool((ball[:, :, 3, 0] + ball[:, :, 3, 9] == 1).all()), "a reset ball is not at (3, 0) or (3, 9)")
    at9 = ball[:, :, 3, 9].mean().item()
    print(f"reset side: ball starts at x = 9 in {at9:.4f} of {ball.shape[0] * ball.shape[1]} resets (expect 0.5)")
    check(abs(at9 - 0.5) < 0.03, f"breakout reset side share {at9}")
    bobs2 = br.breakout_rollout(6, 0.0, bweights, st0, brick0, BT, max_steps=1)[0]
    bact2 = br.breakout_rollout(100, 0.3, bweights, st0, brick0, BT)[1]
    check(not torch.equal(bobs1, bobs2) and not torch.equal(bact, bact2), "breakout: different seeds gave the same stream")
    print("breakout: different seeds give different streams")

    for name, expect in (("asterix_rollout", 0.24), ("freeway_rollout", 0.2), ("space_invaders_rollout", 0.225),
                         ("seaquest_rollout", 0.25)):
        kernel, gA = games[name][0], games[name][4]
        gweights, gstates = game_inputs[name]
        _, gact, _, _, gq, *_ = kernel(99, 0.3, gweights, *gstates, BT)
        p_random = (gact.long() != gq.argmax(-1)).float().mean().item()
        print(f"{name}: P(act != greedy) at eps 0.3, A={gA}: {p_random:.4f} (expect {expect})")
        check(abs(p_random - expect) < 0.02, f"{name} P(act != greedy) = {p_random}")
        gact2 = kernel(100, 0.3, gweights, *gstates, BT)[1]
        check(not torch.equal(gact, gact2), f"{name}: different seeds gave the same actions")

    # Asterix spawns: one step of 8192 envs, each with a random set of free
    # slots and its spawn timer at 0 (nothing moves, nothing collides)
    from purejaxql_torch.envs.minatar.asterix import AsterixState

    NB = 8192
    r = np.random.RandomState(5)
    exists = r.rand(NB, 8) < 0.5
    exists[np.arange(NB), r.randint(0, 8, NB)] = False  # at least one free slot
    i32 = lambda v: torch.full((NB,), v, dtype=torch.int32)  # noqa: E731
    spawn_state = AsterixState(
        player_x=i32(5), player_y=i32(5), e_exists=torch.tensor(exists),
        e_x=torch.full((NB, 8), 2, dtype=torch.int32), e_lr=torch.zeros(NB, 8, dtype=torch.bool),
        e_gold=torch.zeros(NB, 8, dtype=torch.bool), spawn_speed=i32(10), spawn_timer=i32(0),
        move_speed=i32(5), move_timer=i32(5), ramp_timer=i32(50), ramp_index=i32(0),
        terminal=torch.zeros(NB, dtype=torch.bool), time=i32(0),
    )
    spawn_st = ar.state_matrix_from_asterix(spawn_state).to(dev)
    aweights = game_inputs["asterix_rollout"][0]
    spawned = []
    for seed in (7, 8):
        after = ar.asterix_from_state_matrix(ar.asterix_rollout(seed, 0.0, aweights, spawn_st, 1)[6].cpu())
        new = after.e_exists & ~spawn_state.e_exists
        check(bool((new.sum(1) == 1).all()), "asterix: a spawn did not fill exactly one free slot")
        slot = new.int().argmax(1)
        spawned.append(slot)
    rows = torch.arange(NB)
    gold = after.e_gold[rows, slot].float().mean().item()
    right = after.e_lr[rows, slot]
    check(bool(torch.equal(after.e_x[rows, slot], torch.where(right, 0, 9).to(torch.int32))),
          "asterix: a spawn is not at the edge it walks from")
    free = torch.tensor(~exists).float()
    expect = (free / free.sum(1, keepdim=True)).sum(0)
    counts = torch.bincount(slot, minlength=8).float()
    dev_slot = ((counts - expect).abs() / expect).max().item()
    print(
        f"asterix spawns: gold {gold:.4f} (expect 1/3), walking right {right.float().mean().item():.4f} "
        f"(expect 0.5), per-slot count / uniform-over-free-slots expectation off by at most "
        f"{100 * dev_slot:.1f} % over {NB} spawns"
    )
    check(abs(gold - 1 / 3) < 0.02 and abs(right.float().mean().item() - 0.5) < 0.02, "asterix spawn shares")
    check(dev_slot < 0.1, f"asterix: spawned slots not uniform over the free slots ({dev_slot})")
    check(not torch.equal(spawned[0], spawned[1]), "asterix: different seeds gave the same spawns")

    # Freeway resets: one step of 8192 envs at max_steps=1, so every env
    # resets to new car columns and the step's lane speeds and directions
    fst0 = freeway_states(NB, 9)[0].to(dev)
    fweights = game_inputs["freeway_rollout"][0]
    resets = [fr.freeway_from_state_matrix(fr.freeway_rollout(seed, 0.0, fweights, fst0, 1, max_steps=1)[6].cpu())
              for seed in (7, 8)]
    cars = resets[0]
    x_share = torch.bincount(cars.car_x.flatten(), minlength=10).float() / cars.car_x.numel()
    speed = cars.car_speed.abs().flatten()
    s_share = torch.bincount(speed, minlength=6)[1:].float() / speed.numel()
    right = (cars.car_speed > 0).float().mean().item()
    print(
        f"freeway resets: car columns {[round(v, 4) for v in x_share.tolist()]} (expect 0.1 each), "
        f"speeds 1-5 {[round(v, 4) for v in s_share.tolist()]} (expect 0.2 each), "
        f"direction +1 {right:.4f} (expect 0.5), over {cars.car_x.numel()} cars"
    )
    check((x_share - 0.1).abs().max().item() < 0.01 and (s_share - 0.2).abs().max().item() < 0.01
          and abs(right - 0.5) < 0.01, "freeway reset draws")
    check(bool(torch.equal(cars.car_timer, cars.car_speed.abs())) and bool((cars.pos == 9).all()),
          "freeway: a reset's timers or chicken are wrong")
    check(not torch.equal(resets[0].car_x, resets[1].car_x), "freeway: different seeds gave the same resets")

    # Seaquest's draws: one step of 8192 envs with the sub on the surface and
    # its greedy action fire (the head's bias raised), each pool's free slots
    # at random, nothing moving (the lane timers held), every sub about to
    # shoot and both spawn timers due: in every env one friendly bullet, one
    # enemy bullet, one fish or sub and one diver appear, nothing collides
    from purejaxql_torch.envs.minatar.seaquest import SeaquestParams
    from purejaxql_torch.envs.minatar.seaquest import start_state as seaquest_start

    r = np.random.RandomState(6)
    rows = torch.arange(NB)

    def taken(n, one_taken=False):
        """A random set of occupied slots with at least one free (and, when
        asked, at least one occupied)."""
        occ = r.rand(NB, n) < 0.5
        free = r.randint(0, n, NB)
        occ[np.arange(NB), free] = False
        if one_taken:
            occ[np.arange(NB), (free + r.randint(1, n, NB)) % n] = True
        return torch.tensor(occ)

    i32n = lambda a: torch.tensor(np.asarray(a, np.int32))  # noqa: E731
    sq0 = seaquest_start(NB, SeaquestParams(), "cpu")
    sq0.f_exists, sq0.s_exists, sq0.d_exists = taken(8), taken(4, one_taken=True), taken(4)
    sq0.fb_exists, sq0.eb_exists = taken(4), taken(4)
    for pool, n in (("f", 8), ("s", 4), ("d", 4)):
        setattr(sq0, f"{pool}_x", i32n(r.randint(0, 10, (NB, n))))
        setattr(sq0, f"{pool}_y", i32n(r.randint(1, 9, (NB, n))))
        setattr(sq0, f"{pool}_dir", i32n(r.choice([-1, 1], (NB, n))))
        setattr(sq0, f"{pool}_timer", torch.full((NB, n), 100, dtype=torch.int32))
    sq0.s_shot_timer = torch.ones(NB, 4, dtype=torch.int32)
    sq0.fb_x, sq0.eb_x = torch.full((NB, 4), 5, dtype=torch.int32), torch.full((NB, 4), 5, dtype=torch.int32)
    sq0.eb_y = i32n(r.randint(1, 9, (NB, 4)))
    sq0.eb_dir, sq0.fb_dir = i32n(r.choice([-1, 1], (NB, 4))), i32n(r.choice([-1, 1], (NB, 4)))
    sq0.spawn_timer, sq0.diver_spawn_timer = torch.ones(NB, dtype=torch.int32), torch.ones(NB, dtype=torch.int32)
    sq_st0 = sq.state_matrix_from_seaquest(sq0).to(dev)
    qweights = list(game_inputs["seaquest_rollout"][0])
    qweights[9] = qweights[9].clone()
    qweights[9][5] += 1e3  # greedy: fire
    spawned = []
    for seed in (7, 8):
        out = sq.seaquest_rollout(seed, 0.0, qweights, sq_st0, 1)
        check(bool((out[1] == 5).all()) and not bool(out[3].any()), "seaquest: the draw step did not fire or ended")
        spawned.append(sq.seaquest_from_state_matrix(out[6].cpu()))
    after = spawned[0]
    new = {p: getattr(after, f"{p}_exists") & ~getattr(sq0, f"{p}_exists") for p in ("fb", "eb", "f", "s", "d")}
    for p, want_one in (("fb", 1), ("eb", 1), ("d", 1)):
        check(bool((new[p].sum(1) == want_one).all()), f"seaquest: not exactly one new {p} in every env")
    check(bool((new["f"].sum(1) + new["s"].sum(1) == 1).all()), "seaquest: not exactly one new fish or sub")
    shooter = (sq0.s_exists & (sq0.s_exists.cumsum(1) == 1)).int().argmax(1)
    eb_slot = new["eb"].int().argmax(1)
    check(bool(torch.equal(after.eb_x[rows, eb_slot], sq0.s_x[rows, shooter])
               and torch.equal(after.eb_y[rows, eb_slot], sq0.s_y[rows, shooter])),
          "seaquest: the enemy bullet is not where the first sub is")
    is_sub = new["s"].any(1)
    e_slot = torch.where(is_sub, new["s"].int().argmax(1), new["f"].int().argmax(1))
    e_x = torch.where(is_sub, after.s_x[rows, e_slot.clamp(max=3)], after.f_x[rows, e_slot])
    e_y = torch.where(is_sub, after.s_y[rows, e_slot.clamp(max=3)], after.f_y[rows, e_slot])
    d_slot = new["d"].int().argmax(1)
    check(bool(torch.equal(after.d_y[rows, d_slot], e_y) and torch.equal(after.d_x[rows, d_slot], e_x)),
          "seaquest: the diver's lane or edge is not the enemy's")
    lane_share = torch.bincount(e_y, minlength=9)[1:].float() / NB
    right = (e_x == 0).float().mean().item()
    sub_share = is_sub.float().mean().item()
    slot_dev = 0.0
    for p, picked, free, cond in (
        ("fb", new["fb"], ~sq0.fb_exists, None), ("eb", new["eb"], ~sq0.eb_exists, None),
        ("f", new["f"], ~sq0.f_exists, ~is_sub), ("s", new["s"], ~sq0.s_exists, is_sub),
        ("d", new["d"], ~sq0.d_exists, None),
    ):
        if cond is not None:
            picked, free = picked[cond], free[cond]
        freef = free.float()
        expect = (freef / freef.sum(1, keepdim=True)).sum(0)
        counts = picked.float().sum(0)
        slot_dev = max(slot_dev, ((counts - expect).abs() / expect.sqrt()).max().item())
    print(
        f"seaquest draws: lanes 1-8 {[round(v, 4) for v in lane_share.tolist()]} (expect 0.125 each), "
        f"from the left {right:.4f} (expect 0.5), a sub {sub_share:.4f} (expect 1/3); per-slot spawn count off "
        f"the uniform-over-free-slots expectation by at most {slot_dev:.2f} standard deviations over five pools "
        f"and {NB} envs"
    )
    check((lane_share - 0.125).abs().max().item() < 0.02 and abs(right - 0.5) < 0.02 and abs(sub_share - 1 / 3) < 0.02,
          "seaquest spawn shares")
    check(slot_dev < 5.0, f"seaquest: spawned slots not uniform over the free slots ({slot_dev} sd)")
    check(not torch.equal(spawned[0].f_exists, spawned[1].f_exists), "seaquest: different seeds gave the same spawns")

    # epsilon-greedy on the card: P(action != greedy) = eps (A - 1) / A within 4
    # standard deviations over 64 seeds of 1024 envs, every action's count at
    # eps 1 within 4 standard deviations of uniform, other seeds other actions
    qg = torch.zeros(1024, 34, device=dev)
    qg[:, 5] = 1.0
    for eps in (0.1, 0.5):
        acts = torch.cat([eg.eps_greedy(s, qg, eps) for s in range(64)])
        p, n = eps * 33 / 34, acts.numel()
        got = (acts != 5).float().mean().item()
        print(f"eps_greedy P(act != greedy) at eps {eps}: {got:.4f} (expect {p:.4f}, 4 sd {4 * (p * (1 - p) / n) ** 0.5:.4f})")
        check(abs(got - p) < 4 * (p * (1 - p) / n) ** 0.5, f"eps_greedy P(random) at eps {eps}: {got}")
    acts = torch.cat([eg.eps_greedy(s, qg, 1.0) for s in range(64)])
    counts = torch.bincount(acts, minlength=34).float()
    mean = acts.numel() / 34
    dev_sd = ((counts - mean).abs() / (mean * (1 - 1 / 34)) ** 0.5).max().item()
    print(f"eps_greedy at eps 1: 34 action counts off uniform by at most {dev_sd:.2f} standard deviations")
    check(dev_sd < 4, "eps_greedy: random actions are not uniform")
    check((eg.eps_greedy(1, qg, 1.0) != eg.eps_greedy(2, qg, 1.0)).float().mean().item() > 0.9,
          "eps_greedy: different seeds gave the same actions")

    # Pendulum noise and resets: z recovered from u - greedy where greedy is
    # far enough from the bounds that no draw within 6 std is clipped (an
    # unbiased selection), by its mean and variance; reset draws by their
    # range, mean and variance (every step resets at max_steps 1)
    aw, cw, stf, sti = pend_inputs[(32, 64, 256)]
    noise = 0.05
    o = pr.pendulum_ac_rollout(21, noise, aw, cw, stf, sti, 200, linspace_noise=False)
    far = o[2].abs() < 2 - 12 * noise
    z = ((o[1] - o[2]) / (2 * noise))[far]
    n_z = z.numel()
    print(f"pendulum noise: z mean {z.mean().item():.4f} variance {z.var().item():.4f} over {n_z} draws "
          f"(expect 0 and 1; bounds {4 / n_z ** 0.5:.4f}, {4 * (2 / n_z) ** 0.5:.4f})")
    check(n_z > 2000 and abs(z.mean().item()) < 4 / n_z ** 0.5 and abs(z.var().item() - 1) < 4 * (2 / n_z) ** 0.5,
          "pendulum noise is not N(0, 1)")
    lad = pr.pendulum_ac_rollout(21, noise, aw, cw, stf, sti, 1)
    z0 = ((o[1] - o[2]) / (2 * noise))[0, :, 0]
    zl = ((lad[1] - lad[2]) / (2 * noise))[0, :, 0]
    ladder_err = (zl - z0 * torch.arange(64, device=dev) / 63)[far[0, :, 0]].abs().max().item()
    print(f"pendulum ladder: env b's noise is z * b / 63 within {ladder_err:.3g}")
    check(ladder_err < 1e-3, "pendulum: the noise ladder does not scale env b by b / (B - 1)")
    robs = pr.pendulum_ac_rollout(22, 0.0, aw, cw, stf, sti, 200, max_steps=1)[0][1:]
    th, thd = torch.atan2(robs[..., 1], robs[..., 0]), robs[..., 2]
    print(f"pendulum resets: theta in [{th.min().item():.4f}, {th.max().item():.4f}] mean {th.mean().item():.4f} "
          f"var {th.var().item():.4f} (pi^2/3 = 3.2899); theta_dot in [{thd.min().item():.4f}, "
          f"{thd.max().item():.4f}] mean {thd.mean().item():.4f} var {thd.var().item():.4f} (1/3), over {thd.numel()}")
    check(thd.min() >= -1 and thd.max() < 1 and abs(thd.mean().item()) < 0.025 and abs(thd.var().item() - 1 / 3) < 0.02
          and abs(th.mean().item()) < 0.07 and abs(th.var().item() / 3.2899 - 1) < 0.04, "pendulum reset draws")
    other = pr.pendulum_ac_rollout(23, noise, aw, cw, stf, sti, 200, linspace_noise=False)
    robs2 = pr.pendulum_ac_rollout(24, 0.0, aw, cw, stf, sti, 200, max_steps=1)[0][1:]
    check(not torch.equal(other[1], o[1]) and not torch.equal(robs, robs2), "pendulum: different seeds gave the same stream")
    print("pendulum: different seeds give different streams")

    # ---- 5. train pqn_cartpole at full width through the kernels ---------------
    save_path = os.path.join(root, "build", "chip_smoke_models")
    cp_steps = gated(TRAIN_STEPS, 64 * 32)
    outs, wall, launches_cp = train(cli, compose, "pqn_cartpole", cp_steps, save_path, counters)
    cp_updates = cp_steps // 64 // 32
    check_run("cartpole", outs, wall, launches_cp, cp_updates, 64 * 32, "cartpole_rollout", 100 if bars else None)
    saved = load_params(os.path.join(save_path, "CartPole-v1", "pqn_CartPole-v1_seed0.safetensors"))
    check(tuple(saved["Dense_1"]["kernel"].shape) == (256, 256), "saved params have the wrong shape")

    # ---- 6. train pqn_minatar on Breakout at full width through the kernels ----
    bo_steps = gated(BREAKOUT_STEPS, 32 * 128)
    outs, wall, launches_bo = train(
        cli, compose, "pqn_minatar", bo_steps, save_path, counters,
        extra=["ENV_NAME=Breakout-MinAtar"],
    )
    bo_updates = bo_steps // 32 // 128
    bo_last10, bo_eval = check_run("breakout", outs, wall, launches_bo, bo_updates, 32 * 128, "breakout_rollout",
                                   3 if bars else None)
    check(launches_bo["cartpole_rollout"] == 0, "the Breakout run launched the CartPole kernel")
    bo_rate = outs["runner_state"][0].timesteps / wall
    saved = load_params(os.path.join(save_path, "Breakout-MinAtar", "pqn_Breakout-MinAtar_seed0.safetensors"))
    check(tuple(saved["CNN_0"]["Conv_0"]["kernel"].shape) == (3, 3, 4, 16), "saved conv kernel has the wrong shape")
    check(tuple(saved["CNN_0"]["Dense_0"]["kernel"].shape) == (1024, 128), "saved dense kernel has the wrong shape")
    print(json.dumps({"breakout_run": {"env_steps_per_s": bo_rate, "wall_s": wall, "last10_return": bo_last10,
                                       "launches": launches_bo, "card": card}}))
    if bars:
        now = (round(bo_last10, 2), round(bo_eval, 2), breakout_resets[False])
        print(
            f"breakout on the cluster CNN: last-10 mean {now[0]}, last eval {now[1]}, "
            f"{now[2]} resets in the PRNG-off check; recorded with the one-block CNN {BREAKOUT_RECORD}: "
            f"{'equal' if now == BREAKOUT_RECORD else 'DIFFERENT'} (informational: the dense sum's order "
            f"changed; the gate is the check)"
        )

    # ---- 6b. train pqn_minatar on Asterix, the YAML's default game -------------
    as_steps = gated(ASTERIX_STEPS, 32 * 128)
    outs, wall, launches_as = train(cli, compose, "pqn_minatar", as_steps, save_path, counters)
    as_updates = as_steps // 32 // 128
    as_last10, as_eval = check_run(
        "asterix", outs, wall, launches_as, as_updates, 32 * 128, "asterix_rollout", ASTERIX_GATE if bars else None
    )
    as_rate = outs["runner_state"][0].timesteps / wall
    saved = load_params(os.path.join(save_path, "Asterix-MinAtar", "pqn_Asterix-MinAtar_seed0.safetensors"))
    check(tuple(saved["CNN_0"]["Conv_0"]["kernel"].shape) == (3, 3, 4, 16), "asterix: saved conv kernel has the wrong shape")
    print(json.dumps({"asterix_run": {"env_steps_per_s": as_rate, "wall_s": wall, "last10_return": as_last10,
                                      "last_eval_return": as_eval, "gate": ASTERIX_GATE,
                                      "launches": launches_as, "card": card}}))

    # ---- 6c. Freeway and SpaceInvaders, 16 updates each at full width ----------
    # (the eval chunks' share of such a run: scripts/profile_torch_train.py)
    short_launches = {}
    for env_name, rollout in (("Freeway-MinAtar", "freeway_rollout"), ("SpaceInvaders-MinAtar", "space_invaders_rollout")):
        outs, wall, launches = train(
            cli, compose, "pqn_minatar", SHORT_STEPS, save_path, counters, extra=[f"ENV_NAME={env_name}"],
        )
        check_run(env_name, outs, wall, launches, 16, 32 * 128, rollout, None)
        short_launches[rollout] = launches
        print(json.dumps({"short_run": {"env": env_name, "env_steps_per_s": outs["runner_state"][0].timesteps / wall,
                                        "wall_s": wall, "launches": launches, "card": card}}))
    # Freeway's eval: 17 evals (one before training, one after each update at
    # TEST_INTERVAL 0.05 of 16 updates) of 79 chunks of 32 steps; no episode
    # ends before the 2500-step limit, so early exit cuts none of them
    check(short_launches["freeway_rollout"]["freeway_rollout"] == 16 + 17 * 79,
          f"freeway: {short_launches['freeway_rollout']['freeway_rollout']} launches, expected {16 + 17 * 79}")

    # ---- 6c'. Seaquest at full width, 500k steps --------------------------------
    # launches: one a update, and per eval (one before training, one every 5 %
    # of the run) one a 32-step chunk until every env has ended an episode,
    # at most 1000 / 32 -> 32 chunks
    sq_steps = gated(SEAQUEST_STEPS, 32 * 128)
    outs, wall, launches_sq = train(
        cli, compose, "pqn_minatar", sq_steps, save_path, counters, extra=["ENV_NAME=Seaquest-MinAtar"],
    )
    sq_updates = sq_steps // 32 // 128
    sq_evals = 1 + sq_updates // max(1, int(sq_updates * 0.05))
    sq_last10, sq_eval = check_run(
        "seaquest", outs, wall, launches_sq, sq_updates, 32 * 128, "seaquest_rollout", SEAQUEST_GATE if bars else None
    )
    lo, hi = sq_updates + sq_evals, sq_updates + sq_evals * -(-1000 // 32)
    check(lo <= launches_sq["seaquest_rollout"] <= hi,
          f"seaquest: {launches_sq['seaquest_rollout']} rollout launches, outside [{lo}, {hi}]")
    saved = load_params(os.path.join(save_path, "Seaquest-MinAtar", "pqn_Seaquest-MinAtar_seed0.safetensors"))
    check(tuple(saved["CNN_0"]["Conv_0"]["kernel"].shape) == (3, 3, 10, 16),
          "seaquest: saved conv kernel has the wrong shape")
    check(tuple(saved["Dense_0"]["kernel"].shape) == (128, 6), "seaquest: saved head has the wrong shape")
    print(json.dumps({"seaquest_run": {"env_steps_per_s": outs["runner_state"][0].timesteps / wall, "wall_s": wall,
                                       "last10_return": sq_last10, "last_eval_return": sq_eval,
                                       "gate": SEAQUEST_GATE, "launches": launches_sq,
                                       "launch_range": [lo, hi], "card": card}}))

    # ---- 6d. the recurrent trainer on MemoryChain, the FF contrast, CartPole ----
    mc_steps = gated(MEMORY_STEPS, 128 * 32, MEMORY_SHORT_UPDATES)
    outs, wall, launches_mc = train(
        cli, compose, "pqn_rnn_memory_chain", mc_steps, save_path, counters,
        extra=["TEST_NUM_STEPS=64"], policy=("FAST_BPTT", "PALLAS_BPTT", ("EXPLORATION_KERNEL", "pallas")),
    )
    mc_updates = mc_steps // 128 // 32
    mc_grad_steps = mc_updates * 4 * 16
    # the cuda policy's epsilon-greedy kernel: every step of the prefill
    # (window 4 + 128) and of the training rollouts, not the eval's
    mc_rollout_steps = 4 + 128 + mc_updates * 128
    ts = outs["runner_state"][0]
    m = {k: v.cpu().numpy() for k, v in outs["metrics"].items()}
    mc_last3 = float(m["test/returned_episode_returns"][-3:].mean())
    print(
        f"train memory_chain (pqn_rnn, GRU): {ts.timesteps} env steps in {wall:.2f} s wall "
        f"({ts.timesteps / wall:.0f} env-steps/s, eval included); launches {launches_mc}; greedy eval "
        f"returns {[round(float(v), 3) for v in m['test/returned_episode_returns']]}; last-3 mean {mc_last3:.3f}"
    )
    check(ts.timesteps == mc_updates * 128 * 32, "memory_chain: wrong env-step count")
    check(all(p.device.type == "cuda" for p in ts.network.parameters()), "memory_chain: a parameter is not on cuda")
    for name in ("gru_scan_fwd", "gru_scan_bwd", "lambda_returns_closure"):
        check(launches_mc[name] == mc_grad_steps,
              f"memory_chain: {name} launched {launches_mc[name]} times, expected {mc_grad_steps}")
    check(launches_mc["eps_greedy"] == mc_rollout_steps,
          f"memory_chain: eps_greedy launched {launches_mc['eps_greedy']} times, expected {mc_rollout_steps}")
    others = {k: v for k, v in launches_mc.items()
              if not k.startswith("gru_scan") and k not in ("lambda_returns_closure", "eps_greedy") and v}
    check(not others, f"memory_chain: another kernel launched: {others}")
    check(all(np.isfinite(m[k]).all() for k in ("td_loss", "qvals")), "memory_chain: non-finite metrics")
    check(not bars or mc_last3 > MEMORY_GATE,
          f"the recurrent trainer did not remember: last-3 greedy return {mc_last3} <= {MEMORY_GATE}")
    saved = load_params(os.path.join(save_path, "MemoryChain-bsuite", "pqn_rnn_MemoryChain-bsuite_seed0.safetensors"))
    gru = saved["ScannedRNN_0"]["GRUCell_0"]
    check(tuple(gru["ir"]["kernel"].shape) == (258, 256) and tuple(gru["hn"]["kernel"].shape) == (256, 256)
          and "bias" not in gru["hr"], "memory_chain: saved GRU params have the wrong flax tree")
    mc_rate = ts.timesteps / wall
    print(json.dumps({"memory_chain_run": {"env_steps_per_s": mc_rate, "wall_s": wall, "last3_eval_return": mc_last3,
                                           "gate": MEMORY_GATE, "launches": launches_mc, "card": card}}))

    outs, wall, launches_ff = train(
        cli, compose, "pqn_rnn_memory_chain", mc_steps, save_path, counters,
        extra=["TEST_NUM_STEPS=64", "ALG_NAME=pqn"], policy=(),
    )
    ff_returns = outs["metrics"]["test/returned_episode_returns"].cpu().numpy()
    ff_last3 = float(ff_returns[-3:].mean())
    print(
        f"train memory_chain (pqn, feedforward): {wall:.2f} s wall; launches {launches_ff}; "
        f"last-3 greedy eval return {ff_last3:.3f} (must stay below {FF_GATE})"
    )
    check(launches_ff["lambda_returns"] == mc_updates and launches_ff["gru_scan_fwd"] == 0
          and launches_ff["lambda_returns_closure"] == 0 and launches_ff["eps_greedy"] == mc_updates * 128,
          f"memory_chain FF: unexpected launches {launches_ff}")
    check(not bars or ff_last3 < FF_GATE,
          f"the feedforward trainer remembered: last-3 greedy return {ff_last3} >= {FF_GATE}")
    print(json.dumps({"memory_chain_ff_run": {"env_steps_per_s": outs["runner_state"][0].timesteps / wall,
                                              "wall_s": wall, "last3_eval_return": ff_last3, "gate": FF_GATE,
                                              "card": card}}))

    # evals every quarter of the 16 updates (the YAML's 5 % would eval after
    # every update, each 500 unfused steps)
    outs, wall, launches_rc = train(
        cli, compose, "pqn_rnn_cartpole", RNN_CARTPOLE_STEPS, save_path, counters, extra=["TEST_INTERVAL=0.25"],
        policy=("FAST_BPTT", "PALLAS_BPTT", ("EXPLORATION_KERNEL", "pallas")),
    )
    ts = outs["runner_state"][0]
    m = {k: v.cpu().numpy() for k, v in outs["metrics"].items()}
    print(
        f"train cartpole (pqn_rnn, GRU): {ts.timesteps} env steps in {wall:.2f} s wall "
        f"({ts.timesteps / wall:.0f} env-steps/s, eval included); launches {launches_rc}; "
        f"last greedy eval return {float(m['test/returned_episode_returns'][-1]):.2f}"
    )
    check(ts.timesteps == RNN_CARTPOLE_STEPS, "rnn cartpole: wrong env-step count")
    for name in ("gru_scan_fwd", "gru_scan_bwd", "lambda_returns_closure"):
        check(launches_rc[name] == 16 * 4 * 16, f"rnn cartpole: {name} launched {launches_rc[name]} times, expected 1024")
    check(launches_rc["lambda_returns"] == 0, f"rnn cartpole: the gymnax form launched: {launches_rc}")
    check(launches_rc["eps_greedy"] == 4 + 64 + 16 * 64,
          f"rnn cartpole: eps_greedy launched {launches_rc['eps_greedy']} times, expected {4 + 64 + 16 * 64}")
    check(all(np.isfinite(v).all() for k, v in m.items() if not k.startswith("test/")) and
          np.isfinite(m["test/returned_episode_returns"]).all(), "rnn cartpole: non-finite metrics")
    print(json.dumps({"rnn_cartpole_run": {"env_steps_per_s": ts.timesteps / wall, "wall_s": wall,
                                           "launches": launches_rc, "card": card}}))

    # ---- 6e. the actor-critic trainer on Pendulum-v1 ------------------------------
    # with --learning-bars the AC gates' other seeds start now, beside phases 6e-6j
    if bars:
        gate_workers = start_gate_seed_workers(root, os.path.join(root, "build", "chip_smoke_gate_seeds"))
        gate_deadline = time.perf_counter() + AC_GATE_TIMEOUT_S
    pcfg = compose(alg="pqn_pendulum")
    pd_steps = gated(PENDULUM_STEPS, pcfg["NUM_STEPS"] * pcfg["NUM_ENVS"])
    outs, wall, launches_pd = train(
        cli, compose, "pqn_pendulum", pd_steps, save_path, counters, policy=("FUSED_ROLLOUT",),
    )
    pd_updates = pd_steps // pcfg["NUM_STEPS"] // pcfg["NUM_ENVS"]
    n_evals = 1 + pd_updates // max(1, int(pd_updates * pcfg["TEST_INTERVAL"]))
    # an eval runs the episode limit (the trainer's TEST_NUM_STEPS default) in NUM_STEPS chunks
    eval_steps = pcfg.get("TEST_NUM_STEPS", PendulumParams().max_steps_in_episode)
    pd_launches = pd_updates + n_evals * -(-eval_steps // pcfg["NUM_STEPS"])
    ts = outs["runner_state"][0]
    m = {k: v.cpu().numpy() for k, v in outs["metrics"].items()}
    evals = m["test/returned_episode_returns"]
    pd_best = float(evals.max())
    print(
        f"train pendulum (pqn_ac): {ts['actor'].timesteps} env steps in {wall:.2f} s wall "
        f"({ts['actor'].timesteps / wall:.0f} env-steps/s, eval included); launches {launches_pd}; greedy eval "
        f"returns at each eval {[round(float(v), 1) for v in evals[:: max(1, int(pd_updates * 0.1))]]}; "
        f"best {pd_best:.2f}"
    )
    check(ts["actor"].timesteps == pd_updates * pcfg["NUM_STEPS"] * pcfg["NUM_ENVS"], "pendulum: wrong env-step count")
    check(all(p.device.type == "cuda" for s in ts.values() for p in s.network.parameters()),
          "pendulum: a parameter is not on cuda")
    check(launches_pd["lambda_returns"] == pd_updates,
          f"pendulum: lambda_returns launched {launches_pd['lambda_returns']} times, expected {pd_updates}")
    check(launches_pd["pendulum_ac_rollout"] == pd_launches,
          f"pendulum: its rollout kernel launched {launches_pd['pendulum_ac_rollout']} times, expected {pd_launches}")
    others = {k: v for k, v in launches_pd.items() if k not in ("lambda_returns", "pendulum_ac_rollout") and v}
    check(not others, f"pendulum: another kernel launched: {others}")
    check(all(np.isfinite(m[k]).all() for k in ("value_loss", "loss_actor", "returned_episode_returns")),
          "pendulum: non-finite metrics")
    saved = load_params(os.path.join(save_path, "Pendulum-v1", "pqn_ac_Pendulum-v1_seed0.safetensors"))
    check(tuple(saved["actor"]["Dense_0"]["kernel"].shape) == (3, 256)
          and tuple(saved["critic"]["Dense_1"]["kernel"].shape) == (2, 256, 256)
          and tuple(saved["critic"]["LayerNorm_0"]["scale"].shape) == (2, 256),
          "pendulum: saved params have the wrong flax tree")
    print(json.dumps({"pendulum_run": {"env_steps_per_s": ts["actor"].timesteps / wall, "wall_s": wall,
                                       "best_eval_return": pd_best, "gate": PENDULUM_GATE,
                                       "launches": launches_pd, "card": card}}))

    # ---- 6e'. the actor-critic trainer beyond Pendulum, unfused ---------------------------
    # pqn_reacher's 400k run and its gate are phase 6j's, with 4 seeds as one program
    gate_seed0 = {"pendulum": pd_best}
    for alg in AC_SHORT:
        acfg = compose(alg=alg)
        ac_run(cli, compose, make_env, load_params, counters, save_path, card, alg,
               AC_SHORT_UPDATES * acfg["NUM_STEPS"] * acfg["NUM_ENVS"], extra=(f"TEST_INTERVAL={AC_SHORT_TEST_INTERVAL}",))

    # ---- 6f. pqn_craftax at full width: the fast program, every action from eps_greedy ----
    ccfg = compose(alg="pqn_craftax")
    cx_updates = CRAFTAX_STEPS // ccfg["NUM_STEPS"] // ccfg["NUM_ENVS"]
    wrappers.BankedResetVecEnv.refreshes = 0
    outs, wall, launches_cx = train(
        cli, compose, "pqn_craftax", CRAFTAX_STEPS, save_path, counters, policy=CRAFTAX_FAST_POLICY,
    )
    bursts = wrappers.BankedResetVecEnv.refreshes
    ts = outs["runner_state"][0]
    m = {k: v.cpu().numpy() for k, v in outs["metrics"].items()}
    cx_metric, cx_ended = craftax_bar_metric(m)
    cx_rate = ts.timesteps / wall
    print(
        f"train craftax (pqn_craftax, Forager, the fast program): {ts.timesteps} env steps in {wall:.2f} s wall "
        f"({cx_rate:.0f} env-steps/s on {card}); launches {launches_cx}; refresh bursts {bursts}; done-masked "
        f"returned_episode_returns over the last 10 % ({cx_ended} updates with an episode end): {cx_metric:.4f} "
        f"(no bar); achievement_count there {float(m['achievement_count'][-cx_updates // 10:].mean()):.3f}"
    )
    check(isinstance(outs["runner_state"][1][1], wrappers.BankedResetState), "craftax: the training env is not banked")
    check(launches_cx["eps_greedy"] == cx_updates,
          f"craftax: eps_greedy launched {launches_cx['eps_greedy']} times, expected {cx_updates}")
    others = {k: v for k, v in launches_cx.items() if k != "eps_greedy" and v}
    check(not others, f"craftax: a returns or rollout kernel launched: {others}")
    check(bursts == -(-cx_updates // 16), f"craftax: {bursts} refresh bursts, expected {-(-cx_updates // 16)}")
    check(ts.timesteps == CRAFTAX_STEPS, "craftax: wrong env-step count")
    check(all(p.device.type == "cuda" for p in ts.network.parameters()), "craftax: a parameter is not on cuda")
    check(int(ts.network.BatchRenorm_0.steps) == cx_updates, "craftax: the input norm did not step once a grad step")
    check(all(np.isfinite(m[k]).all() for k in ("td_loss", "qvals")), "craftax: non-finite td_loss or qvals")
    check(cx_ended > 0 and np.isfinite(cx_metric), "craftax: no episode ended in the last 10 % of the run")
    saved = load_params(os.path.join(save_path, "Craftax-Symbolic-v1", "pqn_craftax_Craftax-Symbolic-v1_seed0.safetensors"))
    check(tuple(saved["Dense_0"]["kernel"].shape) == (2883, 1024) and tuple(saved["Dense_4"]["kernel"].shape) == (1024, 34)
          and tuple(saved["BatchRenorm_0"]["scale"].shape) == (2883,), "craftax: saved params have the wrong flax tree")
    print(json.dumps({"craftax_run": {"program": "fast", "env_steps_per_s": cx_rate, "wall_s": wall,
                                      "bar_metric": cx_metric, "updates_with_an_end": cx_ended,
                                      "refresh_bursts": bursts, "launches": launches_cx, "card": card}}))
    craftax_one_seed = {"env_steps_per_s": cx_rate, "launches": launches_cx, "refresh_bursts": bursts}

    # the strict program: optimistic resets, concat 1-step TD, a permuted minibatch
    outs, wall, launches_cs = train(
        cli, compose, "pqn_craftax", CRAFTAX_STRICT_STEPS, save_path, counters,
        extra=["PARITY=strict", "EXPLORATION_KERNEL=pallas"], policy=(("EXPLORATION_KERNEL", "pallas"),),
    )
    ts = outs["runner_state"][0]
    cs_updates = CRAFTAX_STRICT_STEPS // ccfg["NUM_ENVS"]
    m = {k: v.cpu().numpy() for k, v in outs["metrics"].items()}
    print(f"train craftax (the strict program): {ts.timesteps} env steps in {wall:.2f} s wall "
          f"({ts.timesteps / wall:.0f} env-steps/s); launches {launches_cs}")
    check(isinstance(outs["runner_state"][1][1], wrappers.LogEnvState), "craftax strict: the training env is banked")
    check(launches_cs["eps_greedy"] == cs_updates and not {k: v for k, v in launches_cs.items() if k != "eps_greedy" and v},
          f"craftax strict: unexpected launches {launches_cs}")
    check(all(np.isfinite(m[k]).all() for k in ("td_loss", "qvals")), "craftax strict: non-finite td_loss or qvals")
    print(json.dumps({"craftax_run": {"program": "strict", "env_steps_per_s": ts.timesteps / wall, "wall_s": wall,
                                      "launches": launches_cs, "card": card}}))

    # the fast program in bfloat16
    outs, wall, launches_cb = train(
        cli, compose, "pqn_craftax", CRAFTAX_BF16_STEPS, save_path, counters, extra=["BF16_COMPUTE=True"],
        policy=CRAFTAX_FAST_POLICY,
    )
    ts = outs["runner_state"][0]
    net = ts.network
    m = {k: v.cpu().numpy() for k, v in outs["metrics"].items()}
    check(launches_cb["eps_greedy"] == CRAFTAX_BF16_STEPS // ccfg["NUM_ENVS"], f"craftax bf16: launches {launches_cb}")
    check(all(np.isfinite(m[k]).all() for k in ("td_loss", "qvals")), "craftax bf16: non-finite td_loss or qvals")
    seen = {}
    hooks = [mod.register_forward_hook(lambda mod_, i, o, name=name: seen.__setitem__(name, o.dtype))
             for name, mod in net.named_modules() if name.startswith(("Dense_", "LayerNorm_"))]
    obs = outs["runner_state"][1][0]
    with torch.no_grad():
        q_bf16 = net(obs, train=False)
    for h in hooks:
        h.remove()
    check(net.dtype == torch.bfloat16 and len(seen) == 9 and set(seen.values()) == {torch.bfloat16},
          f"craftax bf16: the trunk's activations are {seen}")
    check(q_bf16.dtype == torch.float32 and all(t.dtype in (torch.float32, torch.int32) for t in net.state_dict().values()),
          "craftax bf16: a parameter, buffer or the Q-values are not float32")
    f32_net = copy.deepcopy(net)
    f32_net.dtype = torch.float32
    with torch.no_grad():
        q_f32 = f32_net(obs, train=False)
    bf16_err = float((q_bf16 - q_f32).abs().max())
    bf16_scale = float(q_f32.abs().max())
    print(f"train craftax (BF16_COMPUTE): {ts.timesteps} env steps in {wall:.2f} s wall "
          f"({ts.timesteps / wall:.0f} env-steps/s); launches {launches_cb}; bfloat16 forward against float32 on the "
          f"same weights at batch {obs.shape[0]}: max |diff| {bf16_err:.5f}, mean "
          f"{float((q_bf16 - q_f32).abs().mean()):.5f}, max |Q| {bf16_scale:.4f}")
    check(bf16_err <= BF16_BOUND * bf16_scale, f"craftax bf16: forward off float32 by {bf16_err} > "
                                               f"{BF16_BOUND} x {bf16_scale}")
    print(json.dumps({"craftax_run": {"program": "fast, BF16_COMPUTE", "env_steps_per_s": ts.timesteps / wall,
                                      "wall_s": wall, "bf16_max_abs_err": bf16_err, "max_abs_q": bf16_scale,
                                      "launches": launches_cb, "card": card}}))

    # Breakout in bfloat16: the learn phase's trunk in bfloat16, the fused
    # kernel on the float32 master weights
    outs, wall, launches_bb = train(
        cli, compose, "pqn_minatar", SHORT_STEPS, save_path, counters,
        extra=["ENV_NAME=Breakout-MinAtar", "BF16_COMPUTE=True"],
    )
    check_run("breakout bf16", outs, wall, launches_bb, 16, 32 * 128, "breakout_rollout", None)
    check(outs["runner_state"][0].network.dtype == torch.bfloat16, "breakout bf16: the network is not bfloat16")
    print(json.dumps({"short_run": {"env": "Breakout-MinAtar", "BF16_COMPUTE": True,
                                    "env_steps_per_s": outs["runner_state"][0].timesteps / wall, "wall_s": wall,
                                    "launches": launches_bb, "card": card}}))

    # ---- 6g. the VDN trainer: Spread at full width, then SMAX, Kitchen, Hanabi ----
    # every grad step one launch of each GRU scan kernel and of the closure
    # returns, nothing else; the rollout and the eval run no kernel
    vdn_kernels = ("gru_scan_fwd", "gru_scan_bwd", "lambda_returns_closure")

    def check_vdn_launches(name, launches, grad_steps):
        for k in vdn_kernels:
            check(launches[k] == grad_steps, f"{name}: {k} launched {launches[k]} times, expected {grad_steps}")
        others = {k: v for k, v in launches.items() if k not in vdn_kernels and v}
        check(not others, f"{name}: another kernel launched: {others}")

    vcfg = compose(alg="pqn_vdn_spread")
    vdn_steps = gated(VDN_SPREAD_STEPS, vcfg["NUM_STEPS"] * vcfg["NUM_ENVS"])
    outs, wall, launches_vdn = train(
        cli, compose, "pqn_vdn_spread", vdn_steps, save_path, counters, policy=("FAST_BPTT", "PALLAS_BPTT"),
    )
    vdn_updates = vdn_steps // vcfg["NUM_STEPS"] // vcfg["NUM_ENVS"]
    vdn_grad_steps = vdn_updates * vcfg["NUM_EPOCHS"] * vcfg["NUM_MINIBATCHES"]
    ts = outs["runner_state"][0]
    m = {k: v.cpu().numpy() for k, v in outs["metrics"].items()}
    rets = m["returned_episode_returns"]
    tenth = max(1, len(rets) // 10)
    vdn_early, vdn_late = float(rets[:tenth].mean()), float(rets[-tenth:].mean())
    vdn_eval = float(m["test/returned_episode_returns"][-1])
    print(
        f"train spread (pqn_vdn, 3 agents, GRU): {ts.timesteps} env steps in {wall:.2f} s wall "
        f"({ts.timesteps / wall:.0f} env-steps/s, eval included); launches {launches_vdn}; mean team return of the "
        f"first tenth of updates {vdn_early:.3f}, of the last tenth {vdn_late:.3f} (must beat the first by "
        f"{VDN_SPREAD_GATE}); last greedy eval return {vdn_eval:.3f}"
    )
    check(ts.timesteps == vdn_updates * vcfg["NUM_STEPS"] * vcfg["NUM_ENVS"], "spread: wrong env-step count")
    check(all(p.device.type == "cuda" for p in ts.network.parameters()), "spread: a parameter is not on cuda")
    check_vdn_launches("spread", launches_vdn, vdn_grad_steps)
    check(all(np.isfinite(m[k]).all() for k in ("td_loss", "qvals", "returned_episode_returns")),
          "spread: non-finite metrics")
    check(np.isfinite(vdn_eval), "spread: the last greedy eval finished no episode")
    check(not bars or vdn_late > vdn_early + VDN_SPREAD_GATE,
          f"the VDN trainer did not learn Spread: last tenth {vdn_late} <= first tenth {vdn_early} + {VDN_SPREAD_GATE}")
    saved = load_params(os.path.join(save_path, "Spread-v0", "pqn_vdn_rnn_Spread-v0_seed0.safetensors"))
    check(tuple(saved["ScannedRNN_0"]["GRUCell_0"]["ir"]["kernel"].shape) == (256, 256)
          and tuple(saved["Dense_2"]["kernel"].shape) == (256, 5) and "Dense_3" not in saved,
          "spread: saved params have the wrong flax tree (no last action in, one head)")
    print(json.dumps({"vdn_spread_run": {"env_steps_per_s": ts.timesteps / wall, "wall_s": wall,
                                         "early_tenth_return": vdn_early, "late_tenth_return": vdn_late,
                                         "gate": VDN_SPREAD_GATE, "last_eval_return": vdn_eval,
                                         "launches": launches_vdn, "card": card}}))

    for alg in VDN_SHORT:
        acfg = compose(alg=alg)
        steps = VDN_SHORT_UPDATES * acfg["NUM_STEPS"] * acfg["NUM_ENVS"]
        # two evals besides the first (the YAML's 5 % would eval after every update)
        outs, wall, launches_v = train(cli, compose, alg, steps, save_path, counters, extra=["TEST_INTERVAL=0.5"],
                                       policy=("FAST_BPTT", "PALLAS_BPTT"))
        ts = outs["runner_state"][0]
        m = {k: v.cpu().numpy() for k, v in outs["metrics"].items()}
        memory = outs["runner_state"][1]
        print(
            f"train {alg} ({memory.obs.shape[1]} agents, window {memory.obs.shape[0]}, obs {memory.obs.shape[-1]}): "
            f"{ts.timesteps} env steps in {wall:.2f} s wall ({ts.timesteps / wall:.0f} env-steps/s, eval "
            f"included); launches {launches_v}; td_loss {[round(float(v), 4) for v in m['td_loss']]}"
        )
        check(ts.timesteps == steps, f"{alg}: wrong env-step count")
        check_vdn_launches(alg, launches_v, VDN_SHORT_UPDATES * acfg["NUM_EPOCHS"] * acfg["NUM_MINIBATCHES"])
        check(all(np.isfinite(m[k]).all() for k in ("td_loss", "qvals", "returned_episode_returns")),
              f"{alg}: non-finite metrics")
        print(json.dumps({"vdn_short_run": {"alg": alg, "env_steps_per_s": ts.timesteps / wall, "wall_s": wall,
                                            "launches": launches_v, "card": card}}))

    # ---- 6h. pqn_rnn_craftax at full width: LSTM, BatchRenorm input, the reset bank ----
    # the fast program by the cuda policy: FAST_BPTT (the LSTM recurrence in
    # PyTorch, no GRU kernel), the epsilon-greedy kernel on every step of the
    # prefill and of the rollouts, the bank; the closure returns once a grad step
    rcfg = compose(alg="pqn_rnn_craftax")
    check(not rcfg.get("PALLAS_BPTT"), "rnn craftax: the cuda policy turned on PALLAS_BPTT for an LSTM stack")
    rc_updates = RNN_CRAFTAX_STEPS // rcfg["NUM_STEPS"] // rcfg["NUM_ENVS"]
    rc_grad_steps = rc_updates * rcfg["NUM_EPOCHS"] * rcfg["NUM_MINIBATCHES"]
    rc_window = rcfg["MEMORY_WINDOW"] + rcfg["NUM_STEPS"]
    rnn_craftax_policy = ("FAST_BPTT", ("EXPLORATION_KERNEL", "pallas"), ("RESET_BANK", 256))

    def check_rnn_craftax(name, outs, launches, updates):
        """The launches (epsilon-greedy once a rollout step, prefill
        included; the closure returns once a grad step; nothing else), the
        env-step count, the parameters on the card, finite metrics (the
        done-masked infos among them). Returns the metrics."""
        ts = outs["runner_state"][0]
        m = {k: v.cpu().numpy() for k, v in outs["metrics"].items()}
        grad_steps = updates * rcfg["NUM_EPOCHS"] * rcfg["NUM_MINIBATCHES"]
        check(launches["eps_greedy"] == rc_window + updates * rcfg["NUM_STEPS"],
              f"{name}: eps_greedy launched {launches['eps_greedy']} times, expected "
              f"{rc_window + updates * rcfg['NUM_STEPS']}")
        check(launches["lambda_returns_closure"] == grad_steps,
              f"{name}: lambda_returns_closure launched {launches['lambda_returns_closure']} times, "
              f"expected {grad_steps}")
        others = {k: v for k, v in launches.items() if k not in ("eps_greedy", "lambda_returns_closure") and v}
        check(not others, f"{name}: a GRU, rollout or gymnax-form returns kernel launched: {others}")
        check(ts.timesteps == updates * rcfg["NUM_STEPS"] * rcfg["NUM_ENVS"], f"{name}: wrong env-step count")
        check(ts.grad_steps == grad_steps, f"{name}: {ts.grad_steps} grad steps, expected {grad_steps}")
        check(all(p.device.type == "cuda" for p in ts.network.parameters()), f"{name}: a parameter is not on cuda")
        check(int(ts.network.BatchRenorm_0.steps) == grad_steps,
              f"{name}: the input BatchRenorm stepped {int(ts.network.BatchRenorm_0.steps)} times, expected {grad_steps}")
        check(all(np.isfinite(v).all() for v in m.values()), f"{name}: non-finite metrics")
        return m

    outs, wall, launches_rcx = train(
        cli, compose, "pqn_rnn_craftax", RNN_CRAFTAX_STEPS, save_path, counters,
        extra=["TOTAL_TIMESTEPS_DECAY=1e9"], policy=rnn_craftax_policy,
    )
    ts = outs["runner_state"][0]
    m = check_rnn_craftax("rnn craftax", outs, launches_rcx, rc_updates)
    rcx_rate = ts.timesteps / wall
    print(
        f"train rnn craftax (pqn_rnn_craftax, Forager, LSTM H 512, the fast program): {ts.timesteps} env steps in "
        f"{wall:.2f} s wall ({rcx_rate:.0f} env-steps/s on {card}); launches {launches_rcx}; td_loss "
        f"{[round(float(v), 5) for v in m['td_loss']]}; done-masked returned_episode_returns "
        f"{[round(float(v), 3) for v in m['returned_episode_returns']]}"
    )
    check(isinstance(outs["runner_state"][2][4], wrappers.BankedResetState), "rnn craftax: the training env is not banked")
    saved = load_params(os.path.join(save_path, "Craftax-Symbolic-v1", "pqn_rnn_Craftax-Symbolic-v1_seed0.safetensors"))
    lstm = saved["ScannedRNN_0"]["OptimizedLSTMCell_0"]
    check(sorted(lstm) == sorted(["ii", "if", "ig", "io", "hi", "hf", "hg", "ho"])
          and all(tuple(lstm[f"i{g}"]["kernel"].shape) == (512 + 34, 512) and "bias" not in lstm[f"i{g}"]
                  and tuple(lstm[f"h{g}"]["kernel"].shape) == (512, 512) and tuple(lstm[f"h{g}"]["bias"].shape) == (512,)
                  for g in "ifgo")
          and tuple(saved["BatchRenorm_0"]["scale"].shape) == (2883,)
          and tuple(saved["Dense_0"]["kernel"].shape) == (2883, 512)
          and tuple(saved["Dense_1"]["kernel"].shape) == (512, 34) and "GRUCell_0" not in saved["ScannedRNN_0"],
          "rnn craftax: saved params have the wrong flax tree")
    print(json.dumps({"rnn_craftax_run": {"program": "fast", "env_steps_per_s": rcx_rate, "wall_s": wall,
                                          "launches": launches_rcx, "card": card}}))

    # the strict program: optimistic resets, the module path (no FAST_BPTT)
    outs, wall, launches_rcs = train(
        cli, compose, "pqn_rnn_craftax", RNN_CRAFTAX_SHORT_STEPS, save_path, counters,
        extra=["TOTAL_TIMESTEPS_DECAY=1e9", "PARITY=strict", "EXPLORATION_KERNEL=pallas"],
        policy=(("EXPLORATION_KERNEL", "pallas"),),
    )
    ts = outs["runner_state"][0]
    check_rnn_craftax("rnn craftax strict", outs, launches_rcs, 1)
    check(isinstance(outs["runner_state"][2][4], wrappers.LogEnvState), "rnn craftax strict: the training env is banked")
    print(f"train rnn craftax (the strict program, the module path): {ts.timesteps} env steps in {wall:.2f} s wall "
          f"({ts.timesteps / wall:.0f} env-steps/s); launches {launches_rcs}")
    print(json.dumps({"rnn_craftax_run": {"program": "strict", "env_steps_per_s": ts.timesteps / wall, "wall_s": wall,
                                          "launches": launches_rcs, "card": card}}))

    # the fast program with BF16_COMPUTE: the BPTT forward's products in
    # bfloat16 operands, float32 accumulation; its Q-values held against the
    # float32 forward's on the same weights and a minibatch of the memory
    outs, wall, launches_rcb = train(
        cli, compose, "pqn_rnn_craftax", RNN_CRAFTAX_SHORT_STEPS, save_path, counters,
        extra=["TOTAL_TIMESTEPS_DECAY=1e9", "BF16_COMPUTE=True"], policy=rnn_craftax_policy,
    )
    ts = outs["runner_state"][0]
    check_rnn_craftax("rnn craftax bf16", outs, launches_rcb, 1)
    net, memory = ts.network, outs["runner_state"][1]
    rows = slice(0, rcfg["NUM_ENVS"] // rcfg["NUM_MINIBATCHES"])
    window = [memory.obs[:, rows], memory.last_done[:, rows], memory.last_action[:, rows]]
    hs0 = [(c[0, rows], h[0, rows]) for c, h in memory.last_hs]
    with torch.no_grad():
        q_by_dtype = [
            fast_rnn_train_forward(
                dict(net.named_parameters()), dict(net.named_buffers()), hs0, *window,
                num_layers=net.num_layers, num_rnn_layers=net.num_rnn_layers, action_dim=net.action_dim,
                add_last_action=net.add_last_action, norm_input=net.norm_input, cell_type=net.cell_type,
                input_norm_type=net.input_norm_type, compute_dtype=dtype,
            )[1]
            for dtype in (torch.bfloat16, torch.float32)
        ]
    rc_bf16_err = float((q_by_dtype[0] - q_by_dtype[1]).abs().max())
    rc_bf16_scale = float(q_by_dtype[1].abs().max())
    print(f"train rnn craftax (BF16_COMPUTE): {ts.timesteps} env steps in {wall:.2f} s wall "
          f"({ts.timesteps / wall:.0f} env-steps/s); launches {launches_rcb}; the bfloat16 BPTT forward against "
          f"float32 on the same weights over a minibatch window {tuple(q_by_dtype[0].shape)}: max |diff| "
          f"{rc_bf16_err:.5f}, max |Q| {rc_bf16_scale:.4f}")
    check(q_by_dtype[0].dtype == torch.float32, "rnn craftax bf16: the Q-values are not float32")
    check(rc_bf16_err <= BF16_BOUND * rc_bf16_scale,
          f"rnn craftax bf16: forward off float32 by {rc_bf16_err} > {BF16_BOUND} x {rc_bf16_scale}")
    print(json.dumps({"rnn_craftax_run": {"program": "fast, BF16_COMPUTE", "env_steps_per_s": ts.timesteps / wall,
                                          "wall_s": wall, "bf16_max_abs_err": rc_bf16_err, "max_abs_q": rc_bf16_scale,
                                          "launches": launches_rcb, "card": card}}))

    # ---- 6i. several seeds as one program (NUM_SEEDS) ---------------------------
    def check_seeded(name, outs, launches, seeds, n_updates, expected):
        """The checks every seeded run shares: the kernels of ``expected``
        launched as often as one seed's run launches them and no other,
        every metric (seeds, NUM_UPDATES) and finite, every parameter on the
        card with a leading seed axis, lanes apart. Returns the metrics."""
        ts = outs["runner_state"][0]
        m = {k: v.cpu().numpy() for k, v in outs["metrics"].items()}
        for k, n in expected.items():
            check(launches[k] == n, f"{name}: {k} launched {launches[k]} times, expected {n} (one seed's count)")
        others = {k: v for k, v in launches.items() if k not in expected and v}
        check(not others, f"{name}: another kernel launched: {others}")
        check(all(v.shape == (seeds, n_updates) for v in m.values()), f"{name}: metrics not (seeds, NUM_UPDATES)")
        check(all(np.isfinite(m[k]).all() for k in ("td_loss", "qvals", "returned_episode_returns")),
              f"{name}: non-finite metrics")
        params = list(ts.network.parameters())
        check(all(p.device.type == "cuda" and p.shape[0] == seeds for p in params),
              f"{name}: a parameter is not on cuda or has no seed axis")
        check(not torch.equal(params[2][0], params[2][1]), f"{name}: the lanes' params are equal")
        return m

    # the seeded runs evaluate every quarter of the run (TEST_INTERVAL 0.25)
    # instead of every 5 %: the unfused eval has no early exit, and at these
    # lengths the YAML's cadence would eval every update or two
    outs, wall, launches_s8 = train(
        cli, compose, "pqn_cartpole", cp_steps, save_path, counters,
        extra=[f"NUM_SEEDS={SEED_CARTPOLE}", "TEST_INTERVAL=0.25"], policy=(("EXPLORATION_KERNEL", "pallas"),),
    )
    s8_updates = cp_steps // 64 // 32
    m = check_seeded("cartpole seeds", outs, launches_s8, SEED_CARTPOLE, s8_updates,
                     {"eps_greedy": s8_updates * 64, "lambda_returns": s8_updates})
    s8_last10 = m["returned_episode_returns"][:, -10:].mean(1)
    s8_rate = SEED_CARTPOLE * outs["runner_state"][0].timesteps / wall
    print(f"train cartpole, {SEED_CARTPOLE} seeds as one program: {SEED_CARTPOLE} x "
          f"{outs['runner_state'][0].timesteps} env steps in {wall:.2f} s wall ({s8_rate:.0f} env-steps/s aggregate, "
          f"eval included); launches {launches_s8}; each seed's mean of its last 10 returned_episode_returns "
          f"{[round(float(v), 2) for v in s8_last10]}, their mean {float(s8_last10.mean()):.2f} (gate 100)")
    check(not bars or float(s8_last10.mean()) > 100,
          f"cartpole seeds did not learn: mean of the seeds' last-10 {s8_last10.mean()}")
    run_dir = os.path.join(save_path, "CartPole-v1")
    check(all(os.path.exists(os.path.join(run_dir, f"pqn_CartPole-v1_seed0_vmap{i}.safetensors"))
              for i in range(SEED_CARTPOLE)), "cartpole seeds: a per-seed checkpoint is missing")
    print(json.dumps({"seeds_cartpole_run": {"seeds": SEED_CARTPOLE, "env_steps_per_s": s8_rate, "wall_s": wall,
                                             "last10_return_by_seed": s8_last10.tolist(), "launches": launches_s8,
                                             "card": card}}))

    # bench.py's cartpole_seeds64 row, 16 updates, and one seed of the same
    # program beside it
    s64_rates = {}
    for n_seeds in (SEEDS64, 1):
        outs, wall, launches = train(
            cli, compose, "pqn_cartpole", SEEDS64_STEPS, save_path, counters,
            extra=[f"NUM_SEEDS={n_seeds}", "PARITY=strict", "COLLECT_METRICS=False", "TEST_INTERVAL=0.25"],
            policy=(),
        )
        check(launches["lambda_returns"] == 16 and sum(launches.values()) == 16,
              f"cartpole {n_seeds} seeds strict: unexpected launches {launches}")
        s64_rates[n_seeds] = n_seeds * outs["runner_state"][0].timesteps / wall
        print(f"train cartpole, {n_seeds} seed(s), PARITY=strict: {n_seeds} x {outs['runner_state'][0].timesteps} env "
              f"steps in {wall:.2f} s wall ({s64_rates[n_seeds]:.0f} env-steps/s aggregate)")
    print(json.dumps({"seeds64_cartpole_run": {"env_steps_per_s": s64_rates[SEEDS64],
                                               "one_seed_env_steps_per_s": s64_rates[1],
                                               "ratio": s64_rates[SEEDS64] / s64_rates[1], "card": card}}))

    outs, wall, launches_sb = train(
        cli, compose, "pqn_minatar", SHORT_STEPS, save_path, counters,
        extra=["ENV_NAME=Breakout-MinAtar", f"NUM_SEEDS={SEED_BREAKOUT}", "TEST_NUM_STEPS=256", "TEST_INTERVAL=0.25"],
        policy=(("EXPLORATION_KERNEL", "pallas"),),
    )
    check_seeded("breakout seeds", outs, launches_sb, SEED_BREAKOUT, 16, {"eps_greedy": 16 * 32, "lambda_returns": 16})
    sb_rate = SEED_BREAKOUT * outs["runner_state"][0].timesteps / wall
    print(f"train breakout, {SEED_BREAKOUT} seeds, unfused: {wall:.2f} s wall ({sb_rate:.0f} env-steps/s aggregate); "
          f"launches {launches_sb}")
    print(json.dumps({"seeds_breakout_run": {"seeds": SEED_BREAKOUT, "env_steps_per_s": sb_rate, "wall_s": wall,
                                             "launches": launches_sb, "card": card}}))

    outs, wall, launches_sm = train(
        cli, compose, "pqn_rnn_memory_chain", mc_steps, save_path, counters,
        extra=["TEST_NUM_STEPS=64", f"NUM_SEEDS={SEED_MEMORY}"],
        policy=("FAST_BPTT", "PALLAS_BPTT", ("EXPLORATION_KERNEL", "pallas")),
    )
    m = check_seeded("memory_chain seeds", outs, launches_sm, SEED_MEMORY, mc_updates, {
        "gru_scan_fwd": mc_grad_steps, "gru_scan_bwd": mc_grad_steps, "lambda_returns_closure": mc_grad_steps,
        "eps_greedy": mc_rollout_steps,
    })
    sm_last3 = m["test/returned_episode_returns"][:, -3:].mean(1)
    sm_rate = SEED_MEMORY * outs["runner_state"][0].timesteps / wall
    print(f"train memory_chain (pqn_rnn, GRU), {SEED_MEMORY} seeds: {wall:.2f} s wall ({sm_rate:.0f} env-steps/s "
          f"aggregate, eval included); launches {launches_sm}; each seed's last-3 greedy eval "
          f"{[round(float(v), 3) for v in sm_last3]}, their mean {float(sm_last3.mean()):.3f} (gate {MEMORY_GATE})")
    check(not bars or float(sm_last3.mean()) > MEMORY_GATE,
          f"the seeded recurrent trainer did not remember: mean of the seeds' last-3 {sm_last3.mean()}")
    net = outs["runner_state"][0].network
    for i in range(SEED_MEMORY):
        saved = load_params(os.path.join(save_path, "MemoryChain-bsuite",
                                         f"pqn_rnn_MemoryChain-bsuite_seed0_vmap{i}.safetensors"))
        hn = saved["ScannedRNN_0"]["GRUCell_0"]["hn"]["kernel"]
        check(tuple(hn.shape) == (256, 256) and torch.equal(hn, net.ScannedRNN_0.GRUCell_0.hn.weight[i].T.cpu()),
              f"memory_chain seeds: the checkpoint of seed {i} is not lane {i}")
    print(json.dumps({"seeds_memory_chain_run": {"seeds": SEED_MEMORY, "env_steps_per_s": sm_rate, "wall_s": wall,
                                                 "last3_eval_by_seed": sm_last3.tolist(), "gate": MEMORY_GATE,
                                                 "launches": launches_sm, "card": card}}))

    # ---- 6j. the other families with seeds: Craftax, pqn_rnn_craftax, VDN, AC ----
    launches_6j, _ = seeded_families(cli, compose, load_params, wrappers, counters, save_path, card,
                                     craftax_one_seed, bars)

    # ---- with --learning-bars, the AC learning gates over seeds: seed 0 above, the workers' others ----
    if bars:
        t0 = time.perf_counter()
        gate_lines = gate_seed_results(gate_workers, gate_deadline)
        gate_wait = time.perf_counter() - t0
        for run, bar in (("pendulum", PENDULUM_GATE),):
            bests = [gate_seed0[run]] + [gate_lines[(run, k)]["best_eval"] for k in range(1, AC_GATE_SEEDS[run])]
            check(all(np.isfinite(bests)), f"{run}: a seed's best greedy eval is not finite: {bests}")
            passed = sum(b > bar for b in bests)
            print(f"{run} gate over seeds 0-{len(bests) - 1}: best greedy evals {[round(b, 1) for b in bests]}; "
                  f"{passed} of {len(bests)} past {bar}; best {max(bests):.1f}")
            print(json.dumps({f"{run}_gate_seeds": {
                "best_evals": bests, "passed": passed, "seeds": len(bests), "gate": bar, "best": max(bests),
                "worker_env_steps_per_s": [gate_lines[(run, k)]["env_steps_per_s"]
                                           for k in range(1, AC_GATE_SEEDS[run])],
                "waited_s": gate_wait, "card": card,
            }}))
            check(max(bests) > bar, f"the actor-critic trainer did not learn {run} in any of {len(bests)} seeds: "
                                    f"best greedy evals {bests}, none > {bar}")

    # ---- 6k. the host-env path (pqn_host): after the AC gate's workers, whose
    # processes would share the host's cores with the pool's threads ----------
    t_host = time.perf_counter()
    host_env_phase(cli, compose, load_params, counters, save_path, card)
    print(f"phase 6k (host-env path): {time.perf_counter() - t_host:.1f} s wall")

    # ---- 6l. the single-file classic envs: the FF trainer on the four
    # discrete ones, the AC trainer on the dm-suite domains ----------------------
    t_classic = time.perf_counter()
    classic_env_phase(cli, compose, make_env, load_params, counters, save_path, card, dev)
    print(f"phase 6l (classic envs): {time.perf_counter() - t_classic:.1f} s wall")

    # ---- 6m. the shared simulators: the AC trainer on locomotion3d's and
    # manipulation2d's envs ------------------------------------------------------
    t_sim = time.perf_counter()
    shared_sim_phase(cli, compose, make_env, load_params, counters, save_path, card, dev)
    print(f"phase 6m (shared simulators): {time.perf_counter() - t_sim:.1f} s wall")

    # ---- 6n. every network configuration the JAX modules take: batch-stat
    # trunk norms in the CNN and recurrent networks, LSTM in VDN, the Nature
    # trunk in bfloat16, BatchRenorm under BF16_COMPUTE ----------------------------
    network_variants_phase(cli, compose, counters, save_path, card, bars)

    # ---- 6o. the staged API and its tooling: stepwise with resume, segmented
    # training, LOG_VIA_CALLBACK, HYP_TUNE, the rollout tool, stage timings ------
    launches_6o = staged_tooling_phase(cli, compose, counters, save_path, card, bars)

    # ---- 6p. the sharded trainers: 2 ranks of one gloo group on the card,
    # then a (2, 2) mesh of 4; an nccl group of world size 1 -----------------------
    launches_6p = sharded_phase(compose, counters, save_path, card, bars)

    # ---- 7. time the kernels at the trainers' shapes ---------------------------
    timings = {}
    for name, (kernel, plain) in lam_forms.items():
        for shape in LAMBDA_TIMED:
            args = lam_inputs[shape]
            # ms: through the wrapper, as the trainers call it
            k_ms = cuda_time_ms(lambda: kernel(*args, 0.99, 0.95), 200)
            p_ms = cuda_time_ms(lambda: plain(*args, 0.99, 0.95), 20)
            b_ms, b_by = lambda_bound_ms(*shape)
            timings[f"{name}_{shape[0]}x{shape[1]}"] = (k_ms, p_ms, b_ms, b_by)
            print(json.dumps({"timing": name, "shape": list(shape), "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                              "bound_by": b_by, "library_ms": None}))
    for B in (32, 128):
        stf0, sti0 = reset_states(B, 11)
        k_ms = cuda_time_ms(lambda: cr.cartpole_rollout(3, 0.1, weights, stf0, sti0, 64), 20)
        p_ms = cuda_time_ms(lambda: cr.cartpole_rollout_plain(3, 0.1, weights, stf0, sti0, 64), 3, warmup=1)
        b_ms, b_by = rollout_bound_ms(64, B, H, A)
        timings[f"cartpole_rollout_B{B}"] = (k_ms, p_ms, b_ms, b_by)
        print(json.dumps({"timing": "cartpole_rollout", "shape": {"T": 64, "B": B, "H": H}, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by}))
    for name in ("breakout_rollout", "asterix_rollout", "freeway_rollout", "space_invaders_rollout",
                 "seaquest_rollout"):
        kernel, plain, _, gC, gA, _ = games[name]
        gweights, gstates = game_inputs[name]
        k_ms = cuda_time_ms(lambda: kernel(3, 0.1, gweights, *gstates, BT), 50)
        p_ms = cuda_time_ms(lambda: plain(3, 0.1, gweights, *gstates, BT), 3, warmup=1)
        b_ms, b_by = minatar_bound_ms(BT, BB, BH, gA, *GAME_SHAPES[name])
        timings[name] = (k_ms, p_ms, b_ms, b_by)
        print(json.dumps({"timing": name, "shape": {"T": BT, "B": BB, "H": BH, "C": gC, "A": gA}, "ms": k_ms,
                          "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by}))

    for shape in GRU_SHAPES[:2] + GRU_VDN_TIMED:
        xi, keep, h0, w_h, b_hn, g_y, g_hT, res = gru_inputs_by_shape[shape]
        for name, kernel, plain, args, bound in (
            ("gru_scan_fwd", gs.gru_scan_fwd, gs.gru_scan_fwd_plain, (xi, keep, h0, w_h, b_hn), gru_fwd_bound_ms),
            ("gru_scan_bwd", gs.gru_scan_bwd, gs.gru_scan_bwd_plain, (*res, g_y, g_hT), gru_bwd_bound_ms),
        ):
            k_ms = cuda_time_ms(lambda: kernel(*args), 50)
            p_ms = cuda_time_ms(lambda: plain(*args), 3, warmup=1)
            b_ms, b_by = bound(*shape)
            timings[f"{name}_T{shape[0]}_B{shape[1]}"] = (k_ms, p_ms, b_ms, b_by)
            print(json.dumps({"timing": name, "shape": dict(zip("TBH", shape)), "ms": k_ms, "plain_ms": p_ms,
                              "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}))
    # one seeded launch for S seeds against S unseeded launches, and the
    # twin; the bound is S times one seed's
    for (T, S, B, H), (f_args, b_args, lane_args) in seeded_gru.items():
        for name, kernel, plain, args, lane, bound in (
            ("gru_scan_fwd", gs.gru_scan_fwd, gs.gru_scan_fwd_plain, f_args, 0, gru_fwd_bound_ms),
            ("gru_scan_bwd", gs.gru_scan_bwd, gs.gru_scan_bwd_plain, b_args, 1, gru_bwd_bound_ms),
        ):
            k_ms = cuda_time_ms(lambda: kernel(*args), 50)
            u_ms = cuda_time_ms(lambda: [kernel(*la[lane]) for la in lane_args], 50)
            p_ms = cuda_time_ms(lambda: plain(*args), 3, warmup=1)
            b_ms, b_by = bound(T, B, H)
            timings[f"{name}_T{T}_S{S}_B{B}"] = (k_ms, p_ms, S * b_ms, b_by)
            print(json.dumps({"timing": name, "shape": dict(zip("TSBH", (T, S, B, H))), "ms": k_ms,
                              "ms_s_unseeded_launches": u_ms, "plain_ms": p_ms, "bound_ms": S * b_ms,
                              "bound_by": b_by, "library_ms": None}))
        # the yardstick: S calls of cuDNN's GRU (one W_h a call)
        cudnn_gru = torch.nn.GRU(H, H).to(dev)
        x_seq, h_init = torch.randn(T, B, H, device=dev), torch.randn(1, B, H, device=dev)
        with torch.no_grad():
            c_fwd = cuda_time_ms(lambda: [cudnn_gru(x_seq, h_init) for _ in range(S)], 50)
        print(json.dumps({"timing": f"{S} calls of torch.nn.GRU (cuDNN)", "shape": {"T": T, "B": B, "H": H},
                          "cudnn_gru_ms": {"fwd": c_fwd}}))
    # a yardstick, not library_ms: cuDNN's GRU has no resets and does its own
    # input projection, and the port never calls it
    for T, B, H in (GRU_SHAPES[0], GRU_VDN_TIMED[0]):
        cudnn_gru = torch.nn.GRU(H, H).to(dev)
        x_seq = torch.randn(T, B, H, device=dev)
        h_init = torch.randn(1, B, H, device=dev)
        with torch.no_grad():
            c_fwd = cuda_time_ms(lambda: cudnn_gru(x_seq, h_init), 50)
        x_grad = x_seq.clone().requires_grad_(True)

        def cudnn_fwd_bwd():
            ys, h_last = cudnn_gru(x_grad, h_init)
            (ys.sum() + h_last.sum()).backward()

        c_fb = cuda_time_ms(cudnn_fwd_bwd, 50)
        print(json.dumps({"timing": "torch.nn.GRU (cuDNN)", "shape": {"T": T, "B": B, "H": H},
                          "cudnn_gru_ms": {"fwd": c_fwd, "fwd_bwd": c_fb}}))

    aw, cw, stf, sti = pend_inputs[(32, 64, 256)]
    k_ms = cuda_time_ms(lambda: pr.pendulum_ac_rollout(3, 0.5, aw, cw, stf, sti, 32), 50)
    p_ms = cuda_time_ms(lambda: pr.pendulum_rollout_plain(3, 0.5, aw, cw, stf, sti, 32), 3, warmup=1)
    b_ms, b_by = pendulum_bound_ms(32, 64, 256)
    timings["pendulum_ac_rollout"] = (k_ms, p_ms, b_ms, b_by)
    print(json.dumps({"timing": "pendulum_ac_rollout", "shape": {"T": 32, "B": 64, "H": 256}, "ms": k_ms,
                      "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}))

    # Craftax's shape, then the seeded runs' (CartPole 8 and 64 seeds,
    # Breakout 4, Craftax 4, pqn_rnn_craftax 2)
    for shape in (EPS_GREEDY_SHAPES[0], (256, 2), (2048, 2), (512, 3), (4096, 34), (2048, 34), *HOST_EPS_SHAPES,
                  (32, 3), (32, 2)):
        qv = eps_inputs[shape]
        k_ms = cuda_time_ms(lambda: eg.eps_greedy(3, qv, 0.1), 200)
        p_ms = cuda_time_ms(lambda: eg.eps_greedy_plain(3, qv, 0.1), 20)
        a_ms = cuda_time_ms(lambda: torch.argmax(qv, -1), 200)
        b_ms, b_by = eps_greedy_bound_ms(*shape)
        timings["eps_greedy" if shape == EPS_GREEDY_SHAPES[0] else f"eps_greedy_{shape[0]}x{shape[1]}"] = (
            k_ms, p_ms, b_ms, b_by)
        # torch.argmax computes only the greedy half, so it is no library time for the kernel
        print(json.dumps({"timing": "eps_greedy", "shape": dict(zip("EA", shape)), "ms": k_ms, "plain_ms": p_ms,
                          "bound_ms": b_ms, "bound_by": b_by, "argmax_ms": a_ms, "library_ms": None}))

    # ---- 8. the kernel table -----------------------------------------------------
    # launches: each kernel's count from the run of its slice's path (the
    # Pendulum rollout's from the Pendulum run, each MinAtar game's and
    # CartPole's from its fused run); since the seeded families came in, the
    # four kernels they run from those runs, each timed at its seeded shape:
    # eps_greedy's from pqn_craftax with 4 seeds (4096 rows), the GRU scan's
    # and the closure returns' from pqn_vdn_spread with 4 seeds (T 29, 4
    # seeds of 24 rows; targets (28, 4 x 8)), the lambda returns' from
    # pqn_reacher with 4 seeds ((32, 4 x 64)); to each, phase 6o's runs'
    # (the staged API and its tooling)
    kernels = []
    for name, src, replaces, key, launches in (
        ("lambda_returns", "purejaxql_torch/csrc/lambda_returns.cu",
         "purejaxql_tpu/ops/pallas_returns.py:26", "lambda_returns_32x256", launches_6j["reacher"]),
        ("cartpole_rollout", "purejaxql_torch/csrc/cartpole_rollout.cu",
         "purejaxql_tpu/ops/pallas_rollout.py:465", "cartpole_rollout_B32", launches_cp),
        ("breakout_rollout", "purejaxql_torch/csrc/breakout_rollout.cu",
         "purejaxql_tpu/ops/pallas_rollout.py:195", "breakout_rollout", launches_bo),
        ("asterix_rollout", "purejaxql_torch/csrc/asterix_rollout.cu",
         "purejaxql_tpu/ops/pallas_rollout.py:693", "asterix_rollout", launches_as),
        ("freeway_rollout", "purejaxql_torch/csrc/freeway_rollout.cu",
         "purejaxql_tpu/ops/pallas_rollout.py:1039", "freeway_rollout", short_launches["freeway_rollout"]),
        ("space_invaders_rollout", "purejaxql_torch/csrc/space_invaders_rollout.cu",
         "purejaxql_tpu/ops/pallas_rollout.py:1276", "space_invaders_rollout",
         short_launches["space_invaders_rollout"]),
        ("seaquest_rollout", "purejaxql_torch/csrc/seaquest_rollout.cu",
         "purejaxql_tpu/ops/pallas_rollout.py:1689", "seaquest_rollout", launches_sq),
        ("gru_scan_fwd", "purejaxql_torch/csrc/gru_scan_fwd.cu",
         "purejaxql_tpu/ops/fast_rnn.py:224", "gru_scan_fwd_T29_S4_B24", launches_6j["vdn"]),
        ("gru_scan_bwd", "purejaxql_torch/csrc/gru_scan_bwd.cu",
         "purejaxql_tpu/ops/fast_rnn.py:248", "gru_scan_bwd_T29_S4_B24", launches_6j["vdn"]),
        ("pendulum_ac_rollout", "purejaxql_torch/csrc/pendulum_ac_rollout.cu",
         "purejaxql_tpu/ops/pallas_rollout.py:2135", "pendulum_ac_rollout", launches_pd),
        ("eps_greedy", "purejaxql_torch/csrc/eps_greedy.cu",
         "purejaxql_tpu/ops/pallas_explore.py:26", "eps_greedy_4096x34", launches_6j["craftax"]),
        ("lambda_returns_closure", "purejaxql_torch/csrc/lambda_returns.cu",
         "purejaxql_tpu/ops/pallas_returns.py:26", "lambda_returns_closure_28x32", launches_6j["vdn"]),
    ):
        k_ms, p_ms, b_ms, b_by = timings[key]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name] + launches_6o[name] + launches_6p[name], "max_abs_err": errors[name],
            "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        })
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s wall in all, the build included "
          f"(learning bars {'held' if bars else 'printed, not held'}; recorded with them held: "
          f"{RECORDED_WALL_S} s)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
