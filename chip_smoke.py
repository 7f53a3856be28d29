#!/usr/bin/env python3
"""Drive the PyTorch port (`onix_torch/`) end to end on one NVIDIA card.

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --groups   # the several-card check alone

Phases, each of which raises on failure (the script then exits
non-zero and prints no result line) and prints its own wall:

1. build   — compile every kernel in onix_torch/csrc with nvcc (sm_90a)
             and print the build seconds and ptxas report.
2. K1      — call kernel K1's TPU-contract entry point
             (`sample_count_block`) on the card at the main path's
             shapes (and a ragged and a wide-vocabulary shape), hold it
             against its plain PyTorch version on the same inputs, and
             time both with CUDA events (and the kernel with
             torch.profiler). Then K1's in-place block step
             (`gibbs_block_step_`, what the fit runs) against its plain
             version from the same snapshot at those shapes, an odd K
             and a high-collision one (B 65,536 on D 16 x V 32, 20
             repeats):
             z, n_dk, n_wk and n_k exactly equal, every repeat
             identical; the call's time, each kernel's device time, the
             bound and the plain version's time. Then the step with a
             chain axis, one call for all chains (C 8 at the main path,
             C 3 at a ragged block of odd K): equal to its plain version
             and to one-chain calls chain by chain; times at C 8 and
             C 1, and the bound for C chains.
3. K2      — kernel K2 (fused serving) against its plain version at
             every static variant, at the harness bank wave and the
             2^21-event day row, with 64- and 4,096-entry filters and
             M up to 100,000: scores, indices and order equal exactly;
             times, bound, and torch.topk as a selection-half yardstick.
4. fit     — a small fit on the card and on the CPU from one noise
             stream, at one chain and at four: the fits must agree;
             then two sweeps at the main-path shape at one chain and at
             eight, timed and profiled by kernel, with the device
             launches per block step (the same at both).
5. slice   — write a synthetic flow day of 10^6 events into a temporary
             store, run `onix_torch.cli score 2016-07-08 flow -s
             serving.save_fitted=true` at the default config on the
             card, and check its outputs, the planted-anomaly recall,
             K1's launch count and the saved model.
6. serve   — serve that model and 63 load-harness tenants through
             `serve_background` on the card: 24 hourly /score requests
             of the day, 64 Zipf harness requests, the whole day
             through BankService.submit, one wave at M = 100,000,
             /feedback (3 benign, 1 threat) and /score again. Every
             answer equals the plain single-tenant path bit for bit;
             K2's launches equal the bank's dispatches; no fallback.
             Then the day again with `-s lda.n_chains=8`: K1's launches
             those of one chain, the saved theta [8, D, K], the recall.
7. overlap — the port's judged rehearsal on the card for flow, dns and
             proxy at the reference's recipe (100,000 events; 8 chains
             against 16 oracle restarts at 300 sweeps for flow, 16
             against 32 at 400 for dns and proxy; seed 5): top-1k
             overlap against the C++ oracle >= 0.95 and >= the
             oracle's own ceiling less 0.02. The oracle is built with
             make from native/lda_ref and runs on the host's cores. The
             cells run in a child process, niced, beside phases 5-16,
             and are judged after phase 16; its fits on the card and the
             script's kernel timings take one file lock, so no kernel is
             timed beside them.
8. resilience — the small day (250,000 flow events, 5,000 hosts, 250
             planted; the repeated days of phases 8, 10, 11 and 12 run
             at this quarter of phase 5's day) scored once
             uninterrupted, then in another store root under `-s
             lda.checkpoint_every=10 --fault-plan
             fit:sweep@25=preempt,ckpt:save@3=torn`: the run must be
             preempted after sweep 29 with a torn sweep-29 checkpoint on
             disk (30 x its blocks K1 launches); the rerun without the
             plan resumes from sweep 19 (40 x its blocks) and its
             results CSV, clients CSV and saved theta/phi equal the
             uninterrupted run's, its manifest counting the two faults;
             the walls of a save and of the resume load. Then a flow day
             of 2,000,000 events (the "auto" read's threshold) written
             as 4 parts: `score` at the default config reads it column
             by column ("auto"), and
             again with `-s pipeline.columnar=off`; equal CSVs and
             corpus counts, 60 x ceil(N / 65,536) K1 launches each, the
             read, word and corpus walls and the process's peak RSS of
             each run.

9. scale  — the scale day on the sharded engine (one card, a 1x1
             mesh): (a) `onix_torch score` of the phase-5 day with
             `--engine sharded` (60 x ceil(N / 65,536) = 1,860 K1
             launches, recall >= 0.5, stage walls); (b) `run_scale` of
             10^7 flow events at the reference's defaults (K 20, block
             2^17, 20 sweeps, M 3,000, 20,000 hosts, 1,000 planted
             anomalies): 20 x ceil(N / 131,072) = 3,060 K1 launches and
             at least 0.8 of the planted anomalies among the winners,
             events/s end to end and for the pipeline alone; (c) on
             (b)'s model, `select_suspicious_events` under the torch f32
             scan, kernel K2 (one launch) and the bf16 screen: winners
             and scores equal bit for bit, the screen sound; (d) the
             same day fitted on its first 2*10^6 events and scored in
             chunks under ONIX_HOST_WORDS=1; (e) K2 at N = 10^7 and K1
             at B = 131,072 against their plain versions, timed beside
             the f32 scan, the screened scan and torch.topk.
10. sparse and svi — (a) the small day under `-s
             lda.sampler_form=sparse` with `--engine gibbs` and
             `--engine sharded`: no K1 launch, the fit's count
             invariants, recall >= 0.5 and the final ll within
             LL_PARITY_BAND (0.05 relative) of its dense ll (phase 8's
             uninterrupted run); (b) two sweeps of the dense arm (K1)
             and of the sparse arm on the small day's corpus at K 20,
             64, 256 and 1,024: ms a
             sweep (CUDA events), device launches a block step, the
             invariants; (c) the day under `--engine svi`, twice:
             byte-identical results and clients CSVs, no K1 launch,
             2 to lda.svi_max_epochs epochs, recall >= 0.5; epochs,
             E-step iterations a batch, fit and stage walls.
11. stream — the streaming path: (a) the reference's protocol
             (bench.py bench_streaming): 10 batches of 100,000 flow
             events, a warm feed (seeds 500+) then a timed one (900+),
             2^12 buckets, the default config, one arm per batch and one
             at supersteps of 5: winner sets identical per batch, device
             words on every timed batch, no K1 or K2 launch; events/s,
             stage walls, dispatches, E-step iterations and pad shapes
             of each arm; (b) the timed feed again under
             serving.serve_form=fused: one K2 launch a batch, winners
             and order equal to the host tail's, scores within 8 ulps;
             then 3 benign labels from batch 9's alerts (apply_feedback,
             immediate) and batch 9 once more through both tails: K2's
             token_words mode, both tails equal, the dismissed pairs
             gone; K2 at that shape against its plain version, timed
             beside torch.topk, with its byte bound; (c) the small day
             as 4 NetFlow v5 files through `onix_torch.cli stream flow
             --epochs 2` at 2^15 buckets: no K1 launch, the alert CSV
             written, the share of planted events alerted in their own
             file in epoch 2 >= the reference's less 0.05
             (STREAM_REF_SHARE); events/s, prefetch mode, stage walls;
             (d) `ingest flow` of the same files into a fresh store,
             then `score`: its rows, 60 x ceil(N / 65,536) K1
             launches, recall >= 0.5; (e) phase 9 (d)'s day without
             ONIX_HOST_WORDS: words_mode "device", the winners equal to
             the host arm's outside the f32 bin-edge band (its events
             counted and printed), the host arm's count of planted
             anomalies among them, and at least the reference's
             streamed share less 0.05 (SCALE_STREAMED_REF_SHARE).

12. operate and serve — (a) `python -m onix_torch.cli watch flow
             <dir> --drain` over phase 11's four v5 files and a capture
             cut inside its first packet header, with --procs 1 and
             --procs 2 into fresh stores, side by side: the reference's
             exit codes and summary lines (the torn file quarantined
             after the retry budget in one process, retried once a drain
             by the workers), phase 11 (d)'s rows in each store, nothing
             on a second drain; `config`'s hash. (b) `run_scale`
             with generator="sessions" for flow, dns and proxy at the
             reference test's shape (60,000 events, 500 hosts, 16
             sweeps, M 2,000): K1 launches of sweeps x blocks, >= 0.3 of
             the planted anomalies; then flow at
             docs/RECALL_r05_sessions_small.json's shape, its recall
             at 1,000 / 3,000 / 10,000 printed beside the record's.
             (c) the phase-6 model and harness tenants through
             `serve_background` with serving.replicas=2 on the card:
             answers equal the plain path, /feedback reaches both
             replicas before the next /score, mark_down(0) re-homes
             every tenant with its answers unchanged, K2 launches equal
             the replicas' dispatches; peak allocated bytes at 1 and 2
             replicas. (d) the load harness at the reference's bench
             shape (32 tenants, D 2,048, V 1,024, K 20, 96 requests of
             4,096 events, batches of 48, seed 7, uncached) under
             "auto": parity with the sequential path, the residency
             identity at capacity 8, events/s, the dispatch collapse,
             the resolved forms; the overload cell three times. (e) the
             harness under the xla form and fused: xla against fused by
             F0's contract; the ladder drill (K2 raising in-process: on
             the card the ladder has no rung, so the error propagates
             with the flag on and off); the three `*_filtered_fast`
             dispatchers at the day's shapes with a 3-key filter in
             both forms. (f) the serve gate's crossover, in its unit,
             events a scan: the fused select with its gathers against
             the torch f32 scan at N = 2^10 ... 2^24, and the bank's
             fused wave against its xla wave at the harness's 48 rows
             and 2^6 ... 2^14 events a row, three passes each; the
             gate's "cuda" row must be each sweep's crossover within one
             power of two. Every phase leaves serve.form_fallback at 0.
13. lifecycle — (a) K1's lane form (ids and mask one row a lane) at the
             fleet week's two classes (100 lanes x 2,048, K 10, V 128
             and 256, D 256, ragged lanes) and 3 lanes at K 7: one call
             equal to its plain version and to one-lane calls, exactly;
             times, plain times, the bound summed over the lanes. (b)
             `run_fleet` at scripts/exp_fleet.py's defaults cut from 200
             tenants to 50 (7 days, 600 events, K 10, 8 sweeps, M 60,
             seed 3, plants of 8 on days 1 and 7, t0025 poisoned on day
             4): 349 ok tenant-days, the victim reparented, the plant
             bars; K1
             launches = sweeps x blocks over the manifest's class
             refits, K2 launches = the ok tenant-days; a class refit's
             wall by part. (c) the fleet arm against the sequential arm
             at 25 tenants for 2 days: identical ledger bodies and
             lineage, K1 calls a class the fleet's times its lanes. (d)
             `run_daily` at scripts/exp_daily.py's defaults (7 days,
             60,000 events, flow and dns, 24 sweeps cold and 12 warm, K
             20, M 200, seed 0, plants of 60 on days 1 and 7, drift_max
             0.5, a day-4 dismissal) as the cold control and the warm
             arm: every day ok, warm on days 2-7, plant parity, the
             dismissed event gone on the days it recurred; the fit-wall
             ratio; then `python -m onix_torch.pipelines.daily --device
             cuda` at tests/test_daily.py's week under its chaos plan,
             killed with SIGKILL once day 1 is in its ledger and
             restarted (beside (b)-(d)): ledger bodies equal an
             uninterrupted run's. (e)
             `run_campaign` over flow, dns and proxy (40,000 events, 20
             sweeps, K 20, M 200, seed 0, dp 1): the overlapped and
             sequential arms and the chaos plan's resume give identical
             winners, the stage-sum identity holds. (f)
             `OnlineUpdater.nudge_and_save` on phase 5's model: epoch
             up by one, the dismissed pair's score up, the tables and
             the window's scores equal a CPU nudge's within the SVI
             rtol, a live bank serves the new epoch uncached.
14. analyst — (a) `python -m onix_torch.cli setup --device cuda` twice in
             a fresh store: the datatype directories, the archived
             config and the three notebook templates, which import
             `onix_torch`. (b) `run_demo` at the reference's defaults
             (20,000 events a datatype, the default LDA settings,
             serving.save_fitted on): every OA file of each datatype,
             summary.json's `run` block without a null, K1 launches =
             the manifests' block steps; the score and run_oa walls. (c)
             `serve_background` on the card: the UI pages, `/data/` and
             HEAD answer the files on disk, traversal 403/404, the
             notebook routes render or answer the reference's 501
             guidance as the installed Jupyter stack implies (printed),
             a kernel session runs the flow template's load cell
             without torch; no bank until the first /score, which is one
             K2 launch with the plain version's winners. (d) `label
             2016-07-08 flow 1 2 3 --label 3` through the command line,
             one benign pair by POST /feedback (the epoch moves, the
             pair leaves the next /score, winners equal the plain
             version's under the filter), the day re-scored with 4 x
             dupfactor feedback tokens and at least one labelled pair
             scored higher or gone, then `oa` again. (e) `oa` on phase
             5's day at pipeline.max_results: the wall and the rows.
             (f) the demo on the sessions generator in a second store;
             a mixture re-run there is refused.
15. shards — the sharded engine beyond one position and the host
             fabric, on phase 5's day at the default config (K 20,
             block 65,536, 60 sweeps): (a) K1's lane form at the dp 4 x
             mp 2 shard lanes (8 lanes of 65,536 tokens, local chunk
             ids) against its plain version: exact; ms a call, plain
             ms, bound. (b) `onix_torch score --engine sharded -s
             mesh.dp=4 -s mesh.mp=2` with the mesh laid on the one card
             (`OneCardMesh`): K1 launches = 60 x the layout's blocks,
             the count invariants, recall >= 0.5, topic similarity >
             0.9 to phase 5's fit; async tau=1 at dp 4 within
             LL_PARITY_BAND of sync at dp 4; ONIX_DP1_FAST=0 at 1x1
             bit-identical to the fast path. (c) `hostfabric.run_fit`
             on the small day's corpus, 2 workers x 1 position on the
             card (worker_env
             CUDA_VISIBLE_DEVICES=0), gloo (NCCL refuses one card
             twice; the placement's backend and the manifest's say
             gloo): theta, phi_wk and z bit-identical to the in-process
             dp 2 fit, each worker's K1 launches from its result; the
             SIGKILL drill resumes bit-identical. (d) the refusals one
             card implies, by message: `score --engine sharded -s
             mesh.dp=2` and `run_scale(fit_hosts=2)` without
             worker_env. (e) the process groups' backends: the
             shared-card fabric's, and a one-rank NCCL group that a
             child process started beside (b)-(d), with an int32 and a
             float64 all-reduce through the fabric's deadline wait: it
             shows that NCCL's start, both dtypes and the wait ran (a
             sum over one rank is its input, so it cannot show a sum
             right); the phase's wall.
16. placements — the collective-free placements on the one card: (a)
             the load harness at the bench shape of phase 12 (d) through
             the sharded bank ("sharded" pinned in the spec) with 1, 2
             and 4 homes laid on cuda:0 (`OneCardDevices`): winners and
             scores bit-identical to the single bank, K2 launches = the
             dispatches = the sum of `bank.wave.d{i}`, every home with
             waves; fetch wait and batch walls; then K2 at the first
             4-home wave's shape against its plain version, timed with
             its bound and the torch.topk yardstick. (b) `serve_
             background` with serving.bank_shard=sharded over 4 homes on
             cuda:0 against the single form: one /score of 8 harness
             tenants gives the single form's answer and the plain path's
             bit for bit, K2 launches = dispatches. (c) `run_fleet` at
             scripts/exp_fleet.py's widths (600 events, K 10) cut to 50
             tenants and 2 days, over dp 1, 2 and 4 laid on cuda:0
             (`OneCardMesh`): artifacts and lineage bit-identical to dp
             1, K1 launches = sweeps x blocks x distinct devices; K1's
             lane form at a padded class shape the fleet week does not
             cover (22 lanes x 2,048, V 128). (d) the refusals by
             message: a harness bank of 2 devices and a dp 2 fleet
             without the laying.

`--groups` (a host of 2 or more cards) builds the kernels and runs only
what needs several cards, on phase 5's day: (iii) the shard arm with a
dp 2 x mp 2 mesh with its positions on cuda:0..3 (modulo the cards
there are) against the same mesh laid on cuda:0, sync and async tau=1:
z, theta and phi_wk bit-identical, the ll history within 1e-6
relative. Its in-process fold runs in two forms, each in a fresh
process with NCCL_DEBUG unset: the port's peer copies through the home
card, and an NCCL all-reduce among the cards (`nccl_fold`); each fit's
wall as start-up, first superstep and the rest, and its K1 launches.
(i) `hostfabric.run_fit` at the default config over NCCL, 2 workers x
1 card clean and with the SIGKILL drill, and with 4 cards 4 workers x
1 card and 2 workers x 2 cards, each against the in-process fit of as
many positions on cuda:0: z, theta and phi_wk bit-identical, K1
launches sweeps x blocks x cards a worker. (ii) `run_scale(10^6,
fit_hosts=2)` over two cards (NCCL) against both workers on cuda:0
(gloo): theta and phi_wk bit-identical. Then, untimed, short runs with
NCCL_DEBUG=INFO print the transports and the communicators' "Init
timings" lines of the NCCL fold and of the NCCL fabrics. Then the
placements over the cards: the sharded bank with its homes on
cuda:0..3 against the single bank, the fleet over dp 4 against dp 1,
and `run_scale(10^6)` over every visible card, in a fresh process with
each fold, against the same mesh laid on cuda:0: bit-identical, the
scale day's ll history within 1e-6 relative.

Every wait on a child process, an HTTP answer, a fabric generation or a
thread has a limit (WAIT_LIMITS: 3x the step's measured wall, at least
30 s); running out raises an error that names the phase, the step and
what it waited on. Every kernel timing prints a roofline line: the
port's own byte count for the call over its time, as a share of the
card's memory peak (`onix_torch.utils.obs.device_peak_bytes_per_s`),
which may not exceed 1.05.

The last lines of standard output are the card's name and power limit,
a `{"phase_walls": {...}}` line and a `{"kernels": [...]}` line (not in
`--groups`), and `{"ok": true, "device": {...}}`.
Without a CUDA device, or run from a directory that holds no
`onix_torch/`, it exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import pathlib
import re
import statistics
import subprocess
import sys
import tempfile
import time

HERE = pathlib.Path(__file__).resolve().parent

# Main-path shape of kernel K1: the default LDAConfig (K = 20, block
# 65,536) on the 10^6-event flow day (D = 20,575 docs, V = 504 words).
MAIN_B, MAIN_K, MAIN_V, MAIN_D = 65_536, 20, 504, 20_575
ALPHA, ETA = 1.2, 0.01
# K1's shapes: (label, B, K, V, D, padding tokens). The high-collision
# block puts every token on 16 documents x 32 words; an odd K takes the
# sample kernel's scalar form (K % 4 != 0), the others its vector form,
# but for 5,000 topics: too many for a token's scores in a CTA's shared
# memory, they take the one-token-a-CTA row form.
K1_SHAPES = [
    ("main path", MAIN_B, MAIN_K, MAIN_V, MAIN_D, MAIN_B // 10),
    ("ragged", 1000, MAIN_K, MAIN_V, 300, 137),
    ("wide vocabulary", MAIN_B, MAIN_K, 8192, MAIN_D, 0),
    ("high collision", MAIN_B, MAIN_K, 32, 16, 0),
    ("odd topics", 4096, 7, 300, 500, 100),
    ("many topics", 2000, 5000, 64, 100, 100),
]
# H100 SXM float32 operations/s outside the tensor cores (NVIDIA data
# sheet, at the 700 W limit). The memory peak comes from
# `onix_torch.utils.obs.device_peak_bytes_per_s` for the card at hand.
F32_OPS_PER_S = 67e12
# A kernel's achieved bytes/s over the peak may exceed 1 only by timing
# noise: above this share its byte count or its time is wrong.
ROOFLINE_SHARE_MAX = 1.05
# Slice phase: the day and its planted anomalies.
DAY_EVENTS, DAY_HOSTS, DAY_ANOMALIES = 1_000_000, 20_000, 1_000
# The repeated days of phases 8, 10, 11 and 12 (the drill, the sparse and
# svi engines, the v5 files, ingest and watch) run on a quarter of the
# day, at its events a host and its planted share.
SMALL_EVENTS, SMALL_HOSTS, SMALL_ANOMALIES = 250_000, 5_000, 250
RECALL_BAR = 0.5
# Serving phase: the day's model plus 63 tenants of the load harness's
# acceptance class (onix/serving/load_harness.py HarnessSpec), served
# Zipf(1.2) requests of 2,048 events.
SERVE_DATE, HARNESS_DATE = "2016-07-08", "2016-07-09"
HARNESS_TENANTS, HARNESS_D, HARNESS_V, HARNESS_K = 63, 2048, 1024, 20
HARNESS_REQUESTS, HARNESS_EVENTS, ZIPF_A = 64, 2048, 1.2


def card_line() -> str:
    with bounded("nvidia-smi", "the card's name and power limit") as lim:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=lim)
    return out.stdout.strip().splitlines()[0]


T_START = time.perf_counter()


def say(card: str, msg: str) -> None:
    """One line of the run: the card, the seconds since the start, msg."""
    print(f"[{card}] {time.perf_counter() - T_START:7.1f} s {msg}",
          flush=True)


# -- the phase clock and the bounded waits ------------------------------------

# The phase that runs now, each finished phase's wall (s), and each
# bounded wait's longest wall (s) by "phase N: step".
PHASE = {"n": 0}
PHASE_WALLS: dict = {}
WAIT_WALLS: dict = {}
# Every wait of this script (a child process, an HTTP request, a fabric
# generation, a thread's join) by step: seconds before it fails.
# Each limit is 3x the step's longest wall in the whole smoke's run on
# the tree before these limits (PERF.md §5; NVIDIA H100 80GB HBM3,
# 700 W), and at least WAIT_FLOOR_S. A step that the run did not have
# takes 3x the walls of the steps it is made of.
WAIT_FLOOR_S = 30.0
WAIT_LIMITS = {
    "nvidia-smi": WAIT_FLOOR_S,                 # 0.40 s
    "HTTP request": WAIT_FLOOR_S,               # 2.46 s (phase 14)
    "config": WAIT_FLOOR_S,                     # 7.63 s
    "watch drain": 3 * 15.51,
    "watch drains join": 3 * (15.51 + 14.12),   # a --procs run's drains
    "drill day 1 in the ledger": 3 * 12.58,
    "drill kill": WAIT_FLOOR_S,                 # 0.27 s
    "drill restart": 3 * 11.59,
    "drill join": 3 * (12.58 + 0.27 + 11.59),
    "analyst CLI": WAIT_FLOOR_S,                # 9.74 s
    "fabric generation": 3 * 28.03,
    # `--groups`: a generation of the fabric on phase 5's day, a card a
    # worker (its longest, the drill's first, in the first four-card
    # run).
    "card fabric generation": 3 * 33.55,
    "NCCL probe": 3 * 10.05,                    # a child's start
    # `--groups`: a fresh process's start and at most a scale phase's
    # wall (phase 9).
    "fold child": 3 * (10.05 + 37.5),
    "RSS sampler join": WAIT_FLOOR_S,           # 0.00 s
    "overlap process": 3 * 189.6,               # phase 7's three cells
}


class StepTimeout(RuntimeError):
    """A bounded wait ran out: names the phase, the step and what it
    waited on."""


@contextlib.contextmanager
def bounded(step: str, what: str):
    """Time one wait of `step` (yields its limit in seconds, for the
    call's own timeout) and turn its timeout into a StepTimeout that
    names the phase, the step and `what` it waited on."""
    limit = WAIT_LIMITS[step]
    t0 = time.perf_counter()
    try:
        yield limit
    except (subprocess.TimeoutExpired, TimeoutError) as e:
        raise StepTimeout(f"phase {PHASE['n']}, {step}: {what} did not "
                          f"finish within {limit:.0f} s") from e
    finally:
        key = f"phase {PHASE['n']}: {step}"
        WAIT_WALLS[key] = max(WAIT_WALLS.get(key, 0.0),
                              time.perf_counter() - t0)


@contextlib.contextmanager
def phase(card: str, n: int):
    """Run phase `n`: on success print its own wall and keep it."""
    PHASE["n"] = n
    t0 = time.perf_counter()
    yield
    PHASE_WALLS[str(n)] = round(time.perf_counter() - t0, 1)
    say(card, f"phase {n} passed in {PHASE_WALLS[str(n)]} s")


def event_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median milliseconds of `fn()` on the card, each call between its
    own pair of CUDA events. A spin kernel queued ahead of each pair
    keeps the card busy while the host enqueues the call, so the events
    time the device work and not the host's launch cost."""
    import torch
    with timing_lock():
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(2_000_000)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_events(fn, reps: int = 1, attempts: int = 3) -> list:
    """[(name, count, device ms)] of every device op that `reps` calls
    of `fn()` launch, from torch.profiler (CUPTI), summed over the
    calls. CUPTI now and then delivers no device record for a window
    whose kernels ran; such an empty window is profiled again, up to
    `attempts` windows, and the last one is returned (empty when every
    window was)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    ops = []
    for _ in range(attempts):
        with timing_lock(), profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA]) \
                as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ops = [(e.key, e.count, e.self_device_time_total / 1e3)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
        if ops:
            break
    return ops


def most_launches(fn, windows: int = 3) -> list:
    """`device_events(fn)` of the window, of `windows` profiled calls,
    that recorded the most device launches. CUPTI at times drops some
    of a window's records (not only all of them), which can only lower
    a count; the largest is the one closest to what ran."""
    return max((device_events(fn) for _ in range(windows)),
               key=lambda ops: sum(c for _, c, _ in ops))


def profiled(fn, reps: int = 30) -> tuple[dict, float]:
    """({device op: ms per call}, device ops per call) of `fn()` from
    `device_events`: the device time of each kernel and memset `fn`
    launches, and how many it launches a call. Empty and 0 when the
    profiler records no device time."""
    import torch
    fn()
    torch.cuda.synchronize()
    ops = device_events(fn, reps)
    return ({k: ms / reps for k, _, ms in ops},
            sum(c for _, c, _ in ops) / reps)


def profiled_ms(fn, reps: int = 30) -> dict:
    """{kernel: ms per call of `fn()`}, as `profiled`."""
    return profiled(fn, reps)[0]


def k1_pair(parts: dict) -> bool:
    """The profile shows K1's sample and apply kernels and nothing else."""
    return (len(parts) == 2 and any("sample_" in n for n in parts)
            and any("apply_kernel" in n for n in parts))


def k1_profile(fn, reps: int = 30, windows: int = 3) -> dict:
    """{kernel: ms per call} of a K1 call `fn()` from the fullest of
    `windows` profiled windows that shows exactly the sample and the
    apply kernel (`k1_pair`), or from the fullest window of all when
    none does. The profiler at times drops one kernel's records from a
    window whose kernels both ran; a window that keeps both is the one
    closest to what ran."""
    import torch
    fn()
    torch.cuda.synchronize()
    seen = [device_events(fn, reps) for _ in range(windows)]
    parts = [{k: ms / reps for k, _, ms in ops} for ops in seen]
    counts = [sum(c for _, c, _ in ops) for ops in seen]
    pick = [i for i in range(windows) if k1_pair(parts[i])] \
        or range(windows)
    return parts[max(pick, key=lambda i: counts[i])]


# -- phase 1 ----------------------------------------------------------------

def phase_build(card: str) -> None:
    """Compile every kernel source, one nvcc each, all at once; print
    each kernel's ptxas report."""
    from onix_torch import kernels
    t0 = time.perf_counter()
    names = kernels.sources()
    kernels.build_all(names)
    say(card, f"build: {len(names)} kernel source(s) in "
              f"{time.perf_counter() - t0:.2f} s")
    for name in names:
        fn = None
        for line in kernels.build_log(name).splitlines():
            if "Compiling entry function" in line:
                hit = re.search(r"[a-z_]*kernel", line)
                fn = hit.group(0) if hit else line.strip()
            if "registers" in line or "spill" in line:
                say(card, f"build: {name}: {fn}: {line.strip()}")


# -- phase 2 ----------------------------------------------------------------

def k1_inputs(b: int, k: int, v: int, d: int, pad: int, use_gumbel: bool,
              seed: int):
    """Consistent K1 inputs on the card: counts are background counts
    plus the block's own assignments, so excluding a token's topic
    never goes below zero; the last `pad` tokens are padding."""
    import torch
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    dev = "cuda"

    def ints(hi, shape):
        return torch.randint(0, hi, shape, generator=g, device=dev,
                             dtype=torch.int32)

    docs, words, z_old = ints(d, (b,)), ints(v, (b,)), ints(k, (b,))
    mask = torch.ones(b, device=dev)
    if pad:
        mask[b - pad:] = 0.0
        z_old[b - pad:] = k
    real = mask > 0
    zr = z_old[real].long()
    n_dk = ints(40, (d, k))
    n_wk = ints(3000, (v, k))
    one = torch.ones_like(zr, dtype=torch.int32)
    n_dk.view(-1).index_add_(0, docs[real].long() * k + zr, one)
    n_wk.view(-1).index_add_(0, words[real].long() * k + zr, one)
    n_k = n_wk.sum(dim=0, dtype=torch.int32)
    noise = k1_noise(g, b, k, use_gumbel)
    return n_dk, n_wk, n_k, noise, docs, words, z_old, mask


def k1_noise(g, b: int, k: int, use_gumbel: bool):
    """[b, k] f32 noise on the card: Gumbel, or uniforms for the race."""
    import torch
    u = torch.rand((b, k), generator=g, device="cuda")
    if use_gumbel:
        return -torch.log(-torch.log(u.clamp_min(
            torch.finfo(torch.float32).tiny)))
    return u.clamp_min(1e-38)


def _fmt(parts: dict) -> str:
    return ", ".join(f"{k[:48]} {v:.5f} ms" for k, v in parts.items())


def near_ties(scores, ulps: int = 4):
    """Tokens whose two best candidates in their f32 score row lie
    within `ulps` ulps of the best."""
    import torch
    top2 = torch.topk(scores, 2, dim=-1).values
    best, second = top2[:, 0], top2[:, 1]
    ulp = torch.nextafter(best, torch.full_like(best, math.inf)) - best
    return (best - second) <= ulps * ulp


_PEAK: dict = {}


def hbm_peak() -> tuple[float, str]:
    """(bytes/s, provenance) of cuda:0's memory, from
    `device_peak_bytes_per_s`; raises for a card with no spec figure."""
    if not _PEAK:
        import torch

        from onix_torch.utils.obs import device_peak_bytes_per_s
        peak, src = device_peak_bytes_per_s(torch.device("cuda", 0))
        if peak is None:
            raise AssertionError(f"no memory peak for this card: {src}")
        _PEAK.update(peak=peak, src=src)
    return _PEAK["peak"], _PEAK["src"]


def bound_of(nbytes: int, ops: int) -> tuple[float, str]:
    """(bound_ms, bound_by): the larger of the bytes over the card's
    memory peak and the operations over its float32 peak."""
    t_bytes = nbytes / hbm_peak()[0] * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def roofline_check(card: str, label: str, nbytes: int, ms: float) -> None:
    """Print a kernel call's roofline line (`obs.roofline` over the
    port's own byte count for the call) and raise when its share of the
    card's memory peak exceeds ROOFLINE_SHARE_MAX."""
    from onix_torch.utils.obs import roofline
    peak, src = hbm_peak()
    r = roofline(1, ms / 1e3, nbytes, peak)
    share = r["fraction_of_peak"]
    say(card, f"roofline {label}: {nbytes} B in {ms:.5f} ms, "
              f"{r['achieved_bytes_per_s']:.4g} B/s, {share} of the peak "
              f"({src})")
    if share > ROOFLINE_SHARE_MAX:
        raise AssertionError(f"roofline {label}: {share} of the memory "
                             f"peak, above {ROOFLINE_SHARE_MAX}")


def k1_bound(n_dk, n_wk, noise, d, w, mask, use_gumbel):
    """(bound_ms, bound_by, bytes, ops) for one K1 call on this data.
    Bytes: the n_dk and n_wk rows the real tokens touch, n_k, the real
    tokens' noise rows and ids, mask and z_old for every token, z_new
    written, d_wk written. Operations per real token and topic: three
    logs and nine other float ops for Gumbel, one log, two divisions
    and seven others for the race."""
    import torch
    k = n_dk.shape[1]
    real = mask > 0
    n_real = int(real.sum())
    b = int(mask.shape[0])
    rows = (int(torch.unique(d[real]).numel())
            + int(torch.unique(w[real]).numel()))
    nbytes = (rows * k * 4 + k * 4 + n_real * (k * 4 + 8) + b * 12
              + n_wk.numel() * 4)
    ops = n_real * k * (12 if use_gumbel else 10)
    return (*bound_of(nbytes, ops), nbytes, ops)


def phase_kernels(card: str) -> None:
    import torch

    from onix_torch.models import sample_count as sc
    for si, (label, b, k, v, d, pad) in enumerate(K1_SHAPES[:3]):
        for use_gumbel in (True, False):
            sampler = "gumbel" if use_gumbel else "race"
            args = k1_inputs(b, k, v, d, pad, use_gumbel, seed=17 + si)
            kw = dict(alpha=ALPHA, eta=ETA, v_eta=v * ETA,
                      use_gumbel=use_gumbel)
            z, d_wk = sc.sample_count_block(*args, **kw)
            torch.cuda.synchronize()
            z_p, d_wk_p = sc.sample_count_plain(*args, **kw)
            torch.cuda.synchronize()
            n_dk, n_wk, n_k, noise, docs, words, z_old, mask = args
            scores = sc.sample_scores(n_dk, n_wk, n_k, noise, docs, words,
                                      z_old, **kw)
            differ = z != z_p
            tied = near_ties(scores) & (mask > 0)
            n_tie = int((differ & tied).sum())
            n_bad = int((differ & ~tied).sum())
            if n_bad or n_tie > max(1, b // 10_000):
                raise AssertionError(
                    f"K1 {label}/{sampler}: z differs from the plain "
                    f"version at {n_bad} tokens that are no near-tie "
                    f"({n_tie} near-ties)")
            exact = sc.count_delta(z, z_old, words, v, k)
            if not torch.equal(d_wk, exact):
                raise AssertionError(
                    f"K1 {label}/{sampler}: d_wk is not the exact scatter "
                    "of the kernel's own z")
            if int((z[mask == 0] != z_old[mask == 0]).sum()):
                raise AssertionError(f"K1 {label}/{sampler}: a padding "
                                     "token changed topic")
            def kern():
                return sc.sample_count_block(*args, **kw)

            def plain():
                return sc.sample_count_plain(*args, **kw)
            ms, plain_ms = event_ms(kern), event_ms(plain)
            parts = profiled_ms(kern)
            bound_ms, bound_by, nbytes, ops = k1_bound(
                n_dk, n_wk, noise, docs, words, mask, use_gumbel)
            roofline_check(card, f"K1 {label} {sampler}", nbytes, ms)
            say(card, f"K1 {label} B={b} K={k} V={v} D={d} pad={pad} "
                      f"{sampler}: z equal to plain ({n_tie} near-ties), "
                      f"d_wk exact; kernel {ms:.5f} ms, plain "
                      f"{plain_ms:.5f} ms (CUDA events, median of 30); "
                      f"profiler: {_fmt(parts) or 'no device time'}; "
                      f"bound {bound_ms:.5f} ms by {bound_by} "
                      f"({nbytes} B, {ops} ops)")


def step_bound(d, w, z_old, z_new, mask, k, use_gumbel):
    """(bound_ms, bound_by, bytes, ops) for one in-place block step on
    this data: what the function must move, not what this design
    moves. Bytes: the mask of every token and the real tokens' ids,
    once; for each chain (z_old and z_new [B], or [C, B] for C chains)
    the real tokens' noise rows and z_old, z written for the tokens
    whose topic changed, the n_dk and n_wk rows the real tokens touch
    read once, the rows of the tokens whose topic changed written once,
    n_k read and written. The sample kernel's z_new scratch is this
    design's choice and is not counted. Operations as `k1_bound`, for
    every chain."""
    import torch
    real = mask > 0
    n_real = int(real.sum())
    b = int(mask.shape[0])

    def rows(sel):
        return (int(torch.unique(d[sel]).numel())
                + int(torch.unique(w[sel]).numel()))
    zo = z_old.reshape(-1, b)
    zn = z_new.reshape(-1, b)
    nbytes = b * 4 + n_real * 8
    for c in range(zo.shape[0]):
        moved = real & (zn[c] != zo[c])
        nbytes += (n_real * (k * 4 + 4) + int(moved.sum()) * 4
                   + (rows(real) + rows(moved)) * k * 4 + 2 * k * 4)
    ops = zo.shape[0] * n_real * k * (12 if use_gumbel else 10)
    return (*bound_of(nbytes, ops), nbytes, ops)


def step_case(card: str, label: str, b: int, k: int, v: int, d: int,
              pad: int, use_gumbel: bool, seed: int, repeats: int = 1
              ) -> dict:
    """K1's in-place block step at one shape against its plain version
    on the card, each from its own copy of one snapshot: z, n_dk, n_wk
    and n_k must be exactly equal, and z must be what
    `sample_count_block` draws from the snapshot; with `repeats` > 1
    every repeat from the same snapshot must be identical (a step that
    read counts its own block had changed would draw by the schedule).
    Times the call (CUDA events), each kernel (profiler) and the plain
    version, each stepping its own chain on with fresh noise every call
    (the same noise again would redraw the same topics and move almost
    no token). Returns the case's numbers."""
    import itertools

    import torch

    from onix_torch.models import sample_count as sc
    sampler = "gumbel" if use_gumbel else "race"
    n_dk, n_wk, n_k, noise, docs, words, z0, mask = k1_inputs(
        b, k, v, d, pad, use_gumbel, seed=seed)
    kw = dict(alpha=ALPHA, eta=ETA, v_eta=v * ETA, use_gumbel=use_gumbel)
    snap = (n_dk, n_wk, n_k, z0)

    def fresh():
        return [t.clone() for t in snap]

    def step(st, fn=sc.gibbs_block_step_, g=noise):
        fn(st[0], st[1], st[2], st[3], g, docs, words, mask, **kw)
    want = fresh()
    step(want, sc.gibbs_block_step_plain)
    z_snap, _ = sc.sample_count_block(n_dk, n_wk, n_k, noise, docs, words,
                                      z0, mask, **kw)
    torch.cuda.synchronize()
    if not torch.equal(z_snap, want[3]):
        raise AssertionError(f"K1 step {label}/{sampler}: the plain "
                             "step's z is not the snapshot's draw")
    first = None
    for r in range(repeats):
        got = fresh()
        step(got)
        torch.cuda.synchronize()
        for name, a, e in zip(("n_dk", "n_wk", "n_k", "z"), got, want):
            if not torch.equal(a, e):
                bad = int((a != e).sum())
                raise AssertionError(
                    f"K1 step {label}/{sampler} repeat {r}: {name} "
                    f"differs from the plain step at {bad} places")
        if first is None:
            first = got
        elif not all(torch.equal(a, e) for a, e in zip(got, first)):
            raise AssertionError(f"K1 step {label}/{sampler}: "
                                 f"repeat {r} differs from repeat 0")
    n_moved = int(((want[3] != z0) & (mask > 0)).sum())
    err = max(float((a - e).abs().max()) for a, e in zip(first, want))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 10)
    draws = itertools.cycle([k1_noise(gen, b, k, use_gumbel)
                             for _ in range(8)])
    work, plain_work = fresh(), fresh()
    ms = event_ms(lambda: step(work, g=next(draws)))
    plain_ms = event_ms(lambda: step(
        plain_work, sc.gibbs_block_step_plain, next(draws)))
    parts = k1_profile(lambda: step(work, g=next(draws)))
    sample_ms = sum(t for n, t in parts.items() if "sample_" in n)
    apply_ms = sum(t for n, t in parts.items() if "apply_kernel" in n)
    bound_ms, bound_by, nbytes, ops = step_bound(
        docs, words, z0, want[3], mask, k, use_gumbel)
    roofline_check(card, f"K1 step {label} {sampler}", nbytes, ms)
    say(card, f"K1 step {label} B={b} K={k} V={v} D={d} pad={pad} "
              f"{sampler}: z, n_dk, n_wk, n_k equal to plain "
              f"({n_moved} tokens moved"
              + (f", {repeats} repeats identical" if repeats > 1 else "")
              + f"); call {ms:.5f} ms, plain {plain_ms:.5f} ms "
              f"(CUDA events, median of 30); kernels (profiler): "
              f"sample {sample_ms:.5f} ms, apply {apply_ms:.5f} ms, "
              f"{len(parts)} device op(s) a call; bound "
              f"{bound_ms:.5f} ms by {bound_by} ({nbytes} B, {ops} "
              f"ops)")
    if not (sample_ms > 0 and apply_ms > 0 and k1_pair(parts)):
        raise AssertionError(f"K1 step {label}/{sampler}: the "
                             f"call ran {sorted(parts)}, not the "
                             "sample and apply kernels alone")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def phase_step(card: str) -> dict:
    """`step_case` at every shape of K1_SHAPES, both samplers; the
    high-collision shape runs the step 20 times from the same snapshot.
    Returns the main path's row of the kernels line."""
    row = None
    for si, (label, b, k, v, d, pad) in enumerate(K1_SHAPES):
        repeats = 20 if label == "high collision" else 1
        for use_gumbel in (True, False):
            got = step_case(card, label, b, k, v, d, pad, use_gumbel,
                            seed=31 + si, repeats=repeats)
            if si == 0 and use_gumbel:
                # The main path runs the Gumbel form on the card.
                row = {"name": "gibbs_block_step_", "route": "cuda",
                       "source": "onix_torch/csrc/sample_count.cu",
                       "replaces": "onix/models/pallas_gibbs.py:148",
                       "launches": None, **got, "library_ms": None}
    return {"sample_count": row}


def k1_chain_inputs(c: int, b: int, k: int, v: int, d: int, pad: int,
                    use_gumbel: bool, seed: int):
    """K1 inputs for `c` chains on the card: shared ids and mask; per
    chain, background counts plus the chain's own assignments of the
    block, noise [c, b, k], and the block's topics as row 1 of a
    [c, 3, b] z (the kernel takes the strided view z[:, 1], as the fit
    does)."""
    import torch
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    dev = "cuda"

    def ints(hi, shape):
        return torch.randint(0, hi, shape, generator=g, device=dev,
                             dtype=torch.int32)

    docs, words = ints(d, (b,)), ints(v, (b,))
    z_all = ints(k, (c, 3, b))
    mask = torch.ones(b, device=dev)
    if pad:
        mask[b - pad:] = 0.0
        z_all[:, :, b - pad:] = k
    real = mask > 0
    n_dk = ints(40, (c, d, k))
    n_wk = ints(3000, (c, v, k))
    for i in range(c):
        zr = z_all[i, 1][real].long()
        one = torch.ones_like(zr, dtype=torch.int32)
        n_dk[i].view(-1).index_add_(0, docs[real].long() * k + zr, one)
        n_wk[i].view(-1).index_add_(0, words[real].long() * k + zr, one)
    n_k = n_wk.sum(dim=1, dtype=torch.int32)
    noise = torch.stack([k1_noise(g, b, k, use_gumbel) for _ in range(c)])
    return n_dk, n_wk, n_k, z_all, noise, docs, words, mask


# The chain-batched step: (label, C, B, K, V, D, padding tokens). The
# main path at the rehearsal's and the day's C = 8; a ragged block at
# C = 3 with an odd K, the sample kernel's scalar form.
K1_CHAIN_SHAPES = [
    ("main path", 8, MAIN_B, MAIN_K, MAIN_V, MAIN_D, MAIN_B // 10),
    ("ragged odd topics", 3, 1000, 7, 300, 500, 137),
]


def phase_chain_step(card: str) -> dict:
    """K1's in-place block step with a chain axis: one call for every
    chain, z the strided view z[:, 1] of a [C, 3, B] state. From one
    snapshot, the call must equal its plain version (chain by chain)
    exactly in z, n_dk, n_wk and n_k, leave the other rows of z alone,
    and give each chain what a one-chain call on that chain's slices
    gives. Times the C-chain call and, at the main path, a one-chain
    call of the same shape (CUDA events; sample and apply kernels by
    the profiler), with the bound for C chains. Returns the main path's
    Gumbel figures for K1's row."""
    import itertools

    import torch

    from onix_torch.models import sample_count as sc
    out = {}
    for si, (label, c, b, k, v, d, pad) in enumerate(K1_CHAIN_SHAPES):
        for use_gumbel in (True, False):
            sampler = "gumbel" if use_gumbel else "race"
            n_dk, n_wk, n_k, z_all, noise, docs, words, mask = \
                k1_chain_inputs(c, b, k, v, d, pad, use_gumbel,
                                seed=61 + si)
            kw = dict(alpha=ALPHA, eta=ETA, v_eta=v * ETA,
                      use_gumbel=use_gumbel)
            snap = (n_dk, n_wk, n_k, z_all)

            def fresh():
                return [t.clone() for t in snap]

            def step(st, fn=sc.gibbs_block_step_, g=noise):
                fn(st[0], st[1], st[2], st[3][:, 1], g, docs, words, mask,
                   **kw)
            want = fresh()
            step(want, sc.gibbs_block_step_plain)
            got = fresh()
            before = sc.launches
            step(got)
            torch.cuda.synchronize()
            if sc.launches - before != 1:
                raise AssertionError(f"K1 chains {label}/{sampler}: "
                                     f"{sc.launches - before} calls, not 1")
            for name, a, e in zip(("n_dk", "n_wk", "n_k", "z"), got, want):
                for ci in range(c):
                    if not torch.equal(a[ci], e[ci]):
                        bad = int((a[ci] != e[ci]).sum())
                        raise AssertionError(
                            f"K1 chains {label}/{sampler}: chain {ci} "
                            f"{name} differs from the plain step at {bad} "
                            "places")
            if not torch.equal(got[3][:, [0, 2]], z_all[:, [0, 2]]):
                raise AssertionError(f"K1 chains {label}/{sampler}: the "
                                     "call wrote outside z[:, 1]")
            for ci in range(c):
                one = [snap[0][ci].clone(), snap[1][ci].clone(),
                       snap[2][ci].clone(), snap[3][ci, 1].clone()]
                sc.gibbs_block_step_(one[0], one[1], one[2], one[3],
                                     noise[ci].contiguous(), docs, words,
                                     mask, **kw)
                torch.cuda.synchronize()
                for name, a, e in zip(("n_dk", "n_wk", "n_k", "z"), one,
                                      (got[0][ci], got[1][ci], got[2][ci],
                                       got[3][ci, 1])):
                    if not torch.equal(a, e):
                        raise AssertionError(
                            f"K1 chains {label}/{sampler}: chain {ci} "
                            f"{name} differs from a one-chain call")
            n_moved = int(((want[3][:, 1] != z_all[:, 1])
                           & (mask > 0)).sum())
            err = max(float((a.double() - e.double()).abs().max())
                      for a, e in zip(got, want))
            gen = torch.Generator(device="cuda")
            gen.manual_seed(71 + si)
            draws = itertools.cycle([
                torch.stack([k1_noise(gen, b, k, use_gumbel)
                             for _ in range(c)]) for _ in range(4)])
            work, plain_work = fresh(), fresh()
            ms = event_ms(lambda: step(work, g=next(draws)))
            plain_ms = event_ms(lambda: step(
                plain_work, sc.gibbs_block_step_plain, next(draws)),
                reps=10)
            parts = k1_profile(lambda: step(work, g=next(draws)))
            sample_ms = sum(t for n, t in parts.items() if "sample_" in n)
            apply_ms = sum(t for n, t in parts.items()
                           if "apply_kernel" in n)
            bound_ms, bound_by, nbytes, ops = step_bound(
                docs, words, z_all[:, 1], want[3][:, 1], mask, k,
                use_gumbel)
            roofline_check(card, f"K1 chains {label} C={c} {sampler}",
                           nbytes, ms)
            say(card, f"K1 chains {label} C={c} B={b} K={k} V={v} D={d} "
                      f"pad={pad} {sampler}: one call, z, n_dk, n_wk, n_k "
                      f"equal to plain and to {c} one-chain calls "
                      f"({n_moved} tokens moved); call {ms:.5f} ms, plain "
                      f"{plain_ms:.5f} ms (CUDA events, median); kernels "
                      f"(profiler): sample {sample_ms:.5f} ms, apply "
                      f"{apply_ms:.5f} ms, {len(parts)} device op(s) a "
                      f"call; bound {bound_ms:.5f} ms by {bound_by} "
                      f"({nbytes} B, {ops} ops)")
            if not (sample_ms > 0 and apply_ms > 0 and k1_pair(parts)):
                raise AssertionError(f"K1 chains {label}/{sampler}: the "
                                     f"call ran {sorted(parts)}, not the "
                                     "sample and apply kernels alone")
            if si == 0 and use_gumbel:
                st1 = [snap[0][0].clone(), snap[1][0].clone(),
                       snap[2][0].clone(), snap[3][0].clone()]
                draws1 = itertools.cycle([k1_noise(gen, b, k, True)
                                          for _ in range(8)])

                def step1():
                    sc.gibbs_block_step_(st1[0], st1[1], st1[2], st1[3][1],
                                         next(draws1), docs, words, mask,
                                         **kw)
                ms1 = event_ms(step1)
                parts1 = k1_profile(step1)
                sample1 = sum(t for n, t in parts1.items()
                              if "sample_" in n)
                apply1 = sum(t for n, t in parts1.items()
                             if "apply_kernel" in n)
                say(card, f"K1 chains {label}: the same step at C=1 "
                          f"{ms1:.5f} ms a call, sample {sample1:.5f} ms, "
                          f"apply {apply1:.5f} ms; C={c} costs "
                          f"{ms / ms1:.2f}x one chain")
                out = {"chains": c, "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "sample_ms": sample_ms, "apply_ms": apply_ms,
                       "max_abs_err": err, "ms_one_chain": ms1}
    return out


# -- phase 3 ----------------------------------------------------------------

def dirichlet_rows(g, n: int, k: int, conc: float):
    """[n, k] f32 Dirichlet(conc) rows drawn on the card."""
    import torch
    x = torch._standard_gamma(torch.full((n, k), conc, device="cuda"),
                              generator=g)
    return x / x.sum(dim=1, keepdim=True)


def sorted_tables(rng, rows: int, f: int, member_pairs=None,
                  member_words=None):
    """[rows, f] sentinel-padded sorted (hi, lo) uint32 tables as int32
    tensors on the card: each row holds f/2 random keys (half of them
    with the high half >= 2^31) plus that row's given members."""
    import numpy as np

    from onix_torch.feedback.filter import SENTINEL, half_tensor, split_key
    out = np.full((rows, f), SENTINEL, np.uint64)
    for r in range(rows):
        keys = rng.integers(0, 1 << 63, f // 2, dtype=np.uint64)
        keys[::2] |= np.uint64(1 << 63)
        extra = [m[r] for m in (member_pairs, member_words) if m is not None]
        keys = np.unique(np.concatenate([keys, *extra]))[:f]
        out[r, :len(keys)] = keys
    hi, lo = split_key(out.ravel())
    return (half_tensor(hi.reshape(rows, f), "cuda"),
            half_tensor(lo.reshape(rows, f), "cuda"))


def k2_filter(rng, rows: int, f: int, d, w):
    """FilterTables [rows, f] for a bank wave: every row suppresses a
    few of its own (doc, word) pairs and boosts a few others, and
    suppresses one of its words."""
    import numpy as np
    import torch

    from onix_torch.feedback.filter import FilterTables, pack_pair
    dn, wn = d.cpu().numpy(), w.cpu().numpy()
    pairs = pack_pair(dn.astype(np.uint32), wn.astype(np.uint32))
    sup = [pairs[r, rng.integers(0, pairs.shape[1], 5)] for r in range(rows)]
    boo = [pairs[r, rng.integers(0, pairs.shape[1], 5)] for r in range(rows)]
    wsup = [wn[r, :1].astype(np.uint64) for r in range(rows)]
    wboo = [wn[r, 1:2].astype(np.uint64) for r in range(rows)]
    return FilterTables(
        word_suppress=sorted_tables(rng, rows, f, member_words=wsup),
        word_boost=sorted_tables(rng, rows, f, member_words=wboo),
        pair_suppress=sorted_tables(rng, rows, f, member_pairs=sup),
        pair_boost=sorted_tables(rng, rows, f, member_pairs=boo),
        boost_scale=torch.full((rows,), 0.25, device="cuda"))


def k2_bound(kw, n_real: int):
    """(bound_ms, bound_by, bytes, ops) for one K2 call: the columns of
    every event the call must read (up to each row's length) read once,
    the theta/phi rows the real events touch read once, every filter
    table read once, M winners (8 B) per row and the optional score
    stream written. Operations: 2K per real dot-mode event, one per
    event otherwise."""
    import torch
    ops_t = kw["ops"]
    r, n = kw["shape"]
    n_ev = int(kw["row_len"].sum()) if "row_len" in kw else r * n
    cols = {"dot": 2, "min2": 2, "scores": 1}[kw["mode"]]
    if kw["mask"] is not None:
        cols += 1
    if kw["filt"] is not None and kw["mode"] != "dot":
        cols += 4 if kw.get("token_words") else 3   # word and pair keys
    nbytes = n_ev * 4 * cols + kw["max_results"] * r * 8
    if kw.get("return_scores"):
        nbytes += n_ev * 4
    if kw["filt"] is not None:
        nbytes += sum(t.numel() * 4 for fam in kw["filt"][:4] for t in fam)
    ops = n_ev
    if kw["mode"] == "dot":
        theta, phi, d, w = ops_t
        k = theta.shape[-1]
        sl = kw["slots"].to(torch.int64)[:, None]
        real = kw["mask"] > 0
        rows = (int(torch.unique((sl * theta.shape[1] + d)[real]).numel())
                + int(torch.unique((sl * phi.shape[1] + w)[real]).numel()))
        nbytes += rows * k * 4
        ops = n_real * 2 * k
    return (*bound_of(nbytes, ops), nbytes, ops)


def k2_cases():
    """(label, fused_call kwargs) for every K2 case the phase checks;
    `timed` marks the cases it also times. Shapes: the harness bank wave
    (64 rows x 2,048 events, D_pad 2,048, V_pad 1,024, K 20), the
    2^21-event day row and the day's hourly wave (D_pad 32,768, V_pad
    512), a wave at the row form's largest N, the cases the selection
    must get right at both forms (`k2_adversarial`), and small rows for
    every other static variant."""
    import numpy as np
    import torch

    from onix_torch.feedback.filter import FilterTables, pack_pair
    from onix_torch.models import fused_serve as fs
    g = torch.Generator(device="cuda")
    g.manual_seed(23)
    rng = np.random.default_rng(23)
    dev = "cuda"

    def ints(hi, shape):
        return torch.randint(0, hi, shape, generator=g, device=dev,
                             dtype=torch.int32)

    cases = []
    # The harness bank wave: 64 slots of D=2,048 / V=1,024 tenants.
    th = dirichlet_rows(g, 64 * 2048, 20, 0.5).reshape(64, 2048, 20)
    ph = dirichlet_rows(g, 64 * 20, 1024, 0.5).reshape(64, 20, 1024) \
        .transpose(1, 2).contiguous()
    slots = torch.randperm(64, generator=g, device=dev).to(torch.int32)
    d, w = ints(2048, (64, 2048)), ints(1024, (64, 2048))
    mask = torch.ones((64, 2048), device=dev)
    mask[-1, 1500:] = 0.0
    base = dict(ops=(th, ph, d, w), mask=mask, mode="dot", slots=slots,
                max_results=2000, tol=1.1, shape=(64, 2048), timed=True)
    cases.append(("bank wave 64x2048", dict(base, filt=None)))
    for f in (64, 4096):
        cases.append((f"bank wave 64x2048 filter F={f}",
                      dict(base, filt=k2_filter(rng, 64, f, d, w))))
    # A bank wave at the row form's largest N.
    n_max = max(n for n in (1 << e for e in range(6, 22))
                if fs.kernel_form(64, n, 2000, 20) == "row")
    dx, wx = ints(2048, (64, n_max)), ints(1024, (64, n_max))
    cases.append((f"bank wave 64x{n_max} (row form's largest N)",
                  dict(base, ops=(th, ph, dx, wx), filt=None,
                       mask=torch.ones((64, n_max), device=dev),
                       shape=(64, n_max))))
    # The day row: one request of 2^21 events, 2e6 real.
    th_d = dirichlet_rows(g, 32768, 20, 0.5)[None]
    ph_d = dirichlet_rows(g, 20, 512, 0.5).T.contiguous()[None]
    n_day, real = 1 << 21, 2_000_000
    dd, wd = ints(20575, (1, n_day)), ints(504, (1, n_day))
    md = torch.zeros((1, n_day), device=dev)
    md[0, :real] = 1.0
    day = dict(ops=(th_d, ph_d, dd, wd), mask=md, mode="dot",
               slots=torch.zeros(1, dtype=torch.int32, device=dev),
               row_len=torch.tensor([real], dtype=torch.int32, device=dev),
               max_results=2000, tol=1.1, shape=(1, n_day), timed=True)
    cases.append(("day row 2^21", dict(day, filt=None)))
    for f in (64, 4096):
        cases.append((f"day row 2^21 filter F={f}",
                      dict(day, filt=k2_filter(rng, 1, f, dd, wd))))
    cases.append(("day row 2^21 M=100000",
                  dict(day, filt=None, max_results=100_000)))
    # The day's hourly wave, as the day batch runs it: 24 requests of
    # about 83,000 events in R_pad 32 x N_pad 2^17, one tenant.
    n_h = 1 << 17
    lens = torch.randint(80_000, 86_000, (32,), generator=g, device=dev,
                         dtype=torch.int32)
    lens[24:] = 0
    mh = (torch.arange(n_h, device=dev)[None, :] < lens[:, None]).float()
    cases.append(("hourly wave 32x2^17", dict(
        ops=(th_d, ph_d, ints(20575, (32, n_h)), ints(504, (32, n_h))),
        mask=mh, mode="dot", filt=None,
        slots=torch.zeros(32, dtype=torch.int32, device=dev), row_len=lens,
        max_results=2000, tol=1.1, shape=(32, n_h), timed=True)))
    # A tie group of 3,000 equal scores cut at M = 2,000 in a 2^21 row.
    st = 0.01 + 0.99 * torch.rand((1, n_day), generator=g, device=dev)
    pos = torch.randperm(n_day, generator=g, device=dev)
    st[0, pos[:1000]] = torch.rand(1000, generator=g, device=dev) * 0.004
    st[0, pos[1000:4000]] = 0.005
    cases.append(("day row 2^21, 3000 tied scores cut at M", dict(
        ops=(st,), mask=None, mode="scores", filt=None, max_results=2000,
        tol=1.1, shape=(1, n_day), timed=True)))
    for n in (5000, 40_000):
        cases += k2_adversarial(g, n)
    # Every other static variant on small rows (R = 3, N = 5,000):
    # scores quantized to 1/64 so that ties are common.
    r, n = 3, 5000
    sa = torch.floor(torch.rand((r, n), generator=g, device=dev) * 64) / 64
    sb = torch.floor(torch.rand((r, n), generator=g, device=dev) * 64) / 64
    sa[0, :7] = -0.0
    wk_a, wk_b = ints(300, (r, n)), ints(300, (r, n))
    p_hi, p_lo = ints(1 << 30, (r, n)), ints(1 << 30, (r, n))
    p_hi[:, ::3] |= torch.tensor(-(1 << 31), dtype=torch.int32, device=dev)
    pk = pack_pair(p_hi.cpu().numpy().view(np.uint32),
                   p_lo.cpu().numpy().view(np.uint32))
    wn = wk_a.cpu().numpy().astype(np.uint64)
    small_f = FilterTables(
        word_suppress=sorted_tables(rng, r, 64, member_words=wn[:, :3]),
        word_boost=sorted_tables(rng, r, 64, member_words=wn[:, 3:6]),
        pair_suppress=sorted_tables(rng, r, 64, member_pairs=pk[:, :40:2]),
        pair_boost=sorted_tables(rng, r, 64, member_pairs=pk[:, 1:40:2]),
        boost_scale=torch.full((r,), 0.25, device=dev))
    m_small = (torch.rand((r, n), generator=g, device=dev) > 0.2).float()
    m_small[2] = 0.0                    # an all-padding row
    for mode, ops in (("min2", (sa, sb)), ("scores", (sa,))):
        for filt in (None, small_f):
            for use_mask in (False, True):
                for ret in (False, True):
                    tw_opts = (False, True) if mode == "min2" else (False,)
                    for tw in tw_opts:
                        label = (f"{mode} filt={filt is not None} "
                                 f"mask={use_mask} ev={ret} tw={tw}")
                        wk = None
                        if filt is not None:
                            wk = (wk_a, wk_b) if tw else wk_a
                        cases.append((label, dict(
                            ops=ops, mask=m_small if use_mask else None,
                            mode=mode, filt=filt, word_keys=wk,
                            pair_keys=None if filt is None
                            else (p_hi, p_lo),
                            token_words=tw, return_scores=ret,
                            max_results=500, tol=0.5, shape=(r, n))))
    th_s = dirichlet_rows(g, 300, 8, 0.5)
    ph_s = dirichlet_rows(g, 8, 200, 0.5).T.contiguous()
    ds, ws = ints(300, (r, n)), ints(200, (r, n))
    for filt in (None, k2_filter(rng, r, 64, ds, ws)):
        for ret in (False, True):
            cases.append((f"dot filt={filt is not None} ev={ret}", dict(
                ops=(th_s, ph_s, ds, ws), mask=m_small, mode="dot",
                filt=filt, return_scores=ret, max_results=4000,
                tol=0.004, shape=(r, n))))
    big = torch.rand((4, 1 << 19), generator=g, device=dev)
    for m in (100, 2000, 100_000):
        cases.append((f"scores 4x2^19 M={m}", dict(
            ops=(big,), mask=None, mode="scores", filt=None,
            max_results=m, tol=0.9, shape=(4, 1 << 19), timed=True)))
    return cases


def k2_adversarial(g, n: int):
    """K2 cases the selection must get right, at R = 3 rows of N = n
    events (so at the form n takes): M = 1, a tie group across the M-th
    place and M > N; row 0 holds -0.0 beside +0.0, row 1 no qualifying
    event and row 2 exactly one; row_len < N with the smallest scores
    past each row's length; NaN on one side of min2; the dot at K 20
    (16-byte gathers) and K 7 (scalar gathers) over 30 docs x 20 words,
    whose repeated pairs tie. Scores are quantized to 1/64."""
    import torch
    dev = "cuda"
    r, tol = 3, 0.5

    def grid64():
        return torch.floor(torch.rand((r, n), generator=g, device=dev)
                           * 64) / 64

    s = grid64()
    zero = torch.rand(n, generator=g, device=dev) < 0.03
    half = torch.rand(n, generator=g, device=dev) < 0.5
    s[0] = torch.where(zero & half, torch.full_like(s[0], -0.0),
                       torch.where(zero, torch.zeros_like(s[0]), s[0]))
    s[1] = 0.75 + s[1] * 0.25
    s[2] = 0.875
    s[2, n // 3] = 0.125
    m_tie = int((s[0] < 0.25).sum()) + int((s[0] == 0.25).sum()) // 2
    tag = f"adversarial N={n}"
    out = [(f"{tag} scores M={m}", dict(
        ops=(s,), mask=None, mode="scores", filt=None, max_results=m,
        tol=tol, shape=(r, n))) for m in (1, m_tie, n + 100)]
    lens = torch.tensor([n - n // 7, n // 2, n], dtype=torch.int32,
                        device=dev)
    past = torch.arange(n, device=dev)[None, :] >= lens[:, None]
    out.append((f"{tag} scores row_len<N", dict(
        ops=(torch.where(past, torch.full_like(s, -1.0), s),), mask=None,
        mode="scores", filt=None, row_len=lens, max_results=m_tie, tol=tol,
        shape=(r, n))))
    sa, sb = grid64(), grid64()
    sa[:, ::7] = float("nan")
    sb[:, 3::11] = float("nan")
    out.append((f"{tag} min2 NaN one side", dict(
        ops=(sa, sb), mask=None, mode="min2", filt=None, max_results=m_tie,
        tol=tol, shape=(r, n))))
    d = torch.randint(0, 30, (r, n), generator=g, device=dev,
                      dtype=torch.int32)
    w = torch.randint(0, 20, (r, n), generator=g, device=dev,
                      dtype=torch.int32)
    mask = (~past).float()
    mask[1] = 0.0
    for k in (20, 7):
        theta = dirichlet_rows(g, 30, k, 0.5)
        phi = dirichlet_rows(g, k, 20, 0.5).T.contiguous()
        out.append((f"{tag} dot K={k} row_len<N", dict(
            ops=(theta, phi, d, w), mask=mask, mode="dot", filt=None,
            row_len=lens, max_results=min(n // 3, 2000), tol=0.1,
            shape=(r, n))))
    return out


def k2_screened(kw):
    """The screened scores of a K2 case before any filter: the plain
    version's scores, +inf where the mask, the row length or tol
    rejects (the input of the torch.topk yardstick)."""
    import torch

    from onix_torch.models.scoring import score_events_in_order
    ops = kw["ops"]
    if kw["mode"] == "dot":
        s = score_events_in_order(*ops, kw.get("slots"))
    elif kw["mode"] == "min2":
        a, b = ops
        s = torch.where(torch.isnan(a) | torch.isnan(b),
                        torch.full_like(a, float("nan")), torch.minimum(a, b))
    else:
        s = ops[0]
    ok = s < torch.tensor(kw["tol"], dtype=torch.float32, device=s.device)
    if kw["mask"] is not None:
        ok &= kw["mask"] > 0
    if kw.get("row_len") is not None:
        ok &= (torch.arange(s.shape[-1], device=s.device)[None, :]
               < kw["row_len"][:, None])
    return torch.where(ok, s, torch.full_like(s, float("inf")))


def _k2_args(kw):
    keys = ("mask", "word_keys", "pair_keys", "filt", "tol")
    args = [kw["ops"]] + [kw.get(k) for k in keys]
    opts = {k: kw[k] for k in ("mode", "max_results")}
    for k in ("token_words", "return_scores", "slots", "row_len"):
        if k in kw:
            opts[k] = kw[k]
    return args, opts


def phase_k2_kernel(card: str) -> dict:
    """K2 against its plain version on the card at every static variant,
    the serving path's shapes and the cases the selection must get
    right, at both forms: scores, indices, order and the optional score
    stream must agree exactly. Prints each case's form; times the timed
    cases: device launches a call (profiler), the call (CUDA events),
    the kernels alone (profiler), the bound, the plain version and the
    torch.topk yardstick. The harness wave must be one launch of the
    row form, the day row the long-row form."""
    import torch

    from onix_torch.models import fused_serve as fs
    row = None
    for label, kw in k2_cases():
        args, opts = _k2_args(kw)
        got = fs.fused_call(*args, **opts)
        torch.cuda.synchronize()
        want = fs.fused_call_plain(*args, **opts)
        torch.cuda.synchronize()
        if kw.get("return_scores"):
            (got, ev), (want, ev_p) = got, want
            if not torch.equal(ev, ev_p):
                raise AssertionError(f"K2 {label}: score stream differs "
                                     "from the plain version")
        if not (torch.equal(got.scores, want.scores)
                and torch.equal(got.indices, want.indices)):
            bad = int((got.indices != want.indices).sum())
            raise AssertionError(f"K2 {label}: winners differ from the "
                                 f"plain version at {bad} slots")
        n_win = int((got.indices >= 0).sum())
        r, n = kw["shape"]
        m = kw["max_results"]
        k = kw["ops"][0].shape[-1] if kw["mode"] == "dot" else 0
        form = fs.kernel_form(r, n, m, k)
        if not kw.get("timed"):
            say(card, f"K2 {label}: {form} form, equal to plain ({n_win} "
                      "winners)")
            continue

        def kern():
            return fs.fused_call(*args, **opts)

        def plain():
            return fs.fused_call_plain(*args, **opts)
        ms, plain_ms = event_ms(kern), event_ms(plain)
        parts, n_ops = profiled(kern)
        n_real = int((kw["mask"] > 0).sum()) if kw["mask"] is not None \
            else r * n
        bound_ms, bound_by, nbytes, ops = k2_bound(kw, n_real)
        roofline_check(card, f"K2 {label}", nbytes, ms)
        # A yardstick for the selection half alone, not a library time
        # for K2 (no PyTorch call scores, filters and selects):
        # torch.topk over the same screened scores, before any filter.
        topk = "n/a (M > N)"
        if m <= n:
            screened = k2_screened(kw)
            topk_ms = event_ms(lambda: torch.topk(
                screened, m, dim=-1, largest=False, sorted=True))
            topk = f"{topk_ms:.5f} ms"
        say(card, f"K2 {label}: {form} form, equal to plain ({n_win} "
                  f"winners); {n_ops:g} device op(s) a call; call "
                  f"{ms:.5f} ms (CUDA events, median of 30); kernels alone "
                  f"{sum(parts.values()):.5f} ms (profiler); bound "
                  f"{bound_ms:.5f} ms by {bound_by} ({nbytes} B, {ops} ops);"
                  f" plain {plain_ms:.5f} ms; torch.topk of the screened "
                  f"scores, M={m}: {topk}")
        say(card, f"K2 {label}: profiler: {_fmt(parts) or 'no device time'}")
        if label == "bank wave 64x2048" and not (form == "row"
                                                 and n_ops == 1):
            raise AssertionError(f"K2 at the harness wave ran the {form} "
                                 f"form, {n_ops:g} device ops a call, not "
                                 "one launch of the row form")
        if label.startswith("day row") and form != "long":
            raise AssertionError(f"K2 {label} ran the {form} form")
        if label == "bank wave 64x2048":
            fin = torch.isfinite(plain().scores)
            got = kern()
            want = plain()
            err = float(torch.where(fin, (got.scores - want.scores).abs(),
                                    torch.zeros_like(got.scores)).max())
            row = {"name": "fused_serve", "route": "cuda",
                   "source": "onix_torch/csrc/fused_serve.cu",
                   "replaces": "onix/models/pallas_serve.py:325",
                   "launches": None, "max_abs_err": err, "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, "library_ms": None}
    return {"fused_serve": row}


# -- phase 4 ----------------------------------------------------------------

class CarriedNoise:
    """One noise stream drawn on the CPU and carried to `device`, so a
    fit on the card and a fit on the CPU sample from the same numbers
    (for `n_chains` chains, the [C, ...] draws of `TorchNoise`)."""

    def __init__(self, seed: int, device, n_chains: int = 1):
        from onix_torch.models.lda_gibbs import TorchNoise
        self.src = TorchNoise(seed, "cpu", n_chains=n_chains)
        self.device = device

    def init_topics(self, shape, n_topics):
        return self.src.init_topics(shape, n_topics).to(self.device)

    def block(self, b, k, use_gumbel):
        return self.src.block(b, k, use_gumbel).to(self.device)


def phase_fit(card: str) -> None:
    """A small fit on the card and on the CPU from one carried noise
    stream, at one chain and at four: z must agree on >= 0.999 of the
    tokens and every ll point to 1e-4 relative, and the card's counts
    keep their invariants chain by chain."""
    import numpy as np
    import torch

    from onix_torch.config import LDAConfig
    from onix_torch.corpus import synthetic_lda_corpus
    from onix_torch.models.lda_gibbs import GibbsLDA
    corpus, _, _ = synthetic_lda_corpus(300, 200, 8, mean_doc_len=60,
                                        seed=4)
    for chains in (1, 4):
        cfg = LDAConfig(n_topics=8, n_sweeps=3, burn_in=1, block_size=4096,
                        seed=2, n_chains=chains)
        out = {}
        for dev in ("cuda", "cpu"):
            model = GibbsLDA(cfg, corpus.n_docs, corpus.n_vocab, device=dev,
                             sampler="gumbel")
            out[dev] = model.fit(corpus, noise=CarriedNoise(cfg.seed, dev,
                                                            chains))
        z_gpu = out["cuda"]["state"].z.cpu().numpy()
        z_cpu = out["cpu"]["state"].z.numpy()
        agree = float((z_gpu == z_cpu).mean())
        ll_gpu = np.array([ll for _, ll in out["cuda"]["ll_history"]])
        ll_cpu = np.array([ll for _, ll in out["cpu"]["ll_history"]])
        rel = float(np.max(np.abs(ll_gpu - ll_cpu) / np.abs(ll_cpu)))
        say(card, f"fit: {corpus.n_tokens} tokens, {chains} chain(s), 3 "
                  f"sweeps on card and CPU from one noise stream: z "
                  f"agreement {agree:.6f}, ll max rel diff {rel:.3e}, "
                  f"theta {out['cuda']['theta'].shape}")
        if agree < 0.999 or rel > 1e-4:
            raise AssertionError(f"fit of {chains} chain(s) on the card "
                                 "disagrees with the CPU fit")
        st = out["cuda"]["state"]
        n_k = st.n_k.reshape(chains, -1)
        n_dk = st.n_dk.reshape(chains, corpus.n_docs, -1)
        n_wk = st.n_wk.reshape(chains, corpus.n_vocab, -1)
        if not (np.isfinite(ll_gpu).all()
                and (n_k.sum(dim=1) == corpus.n_tokens).all()
                and (n_dk.sum(dim=(1, 2)) == corpus.n_tokens).all()
                and torch.equal(n_k, n_wk.sum(dim=1, dtype=torch.int32))):
            raise AssertionError("fit on the card broke a count invariant")


def phase_fit_profile(card: str) -> None:
    """Where a fit's time goes at the main-path shape: two sweeps of a
    synthetic corpus of D x V = 20,575 x 504 and ~2e6 tokens, at one
    chain and at eight, timed plain and then under torch.profiler for
    device time by kernel. The device launches a block step (the noise
    draw's and K1's) must not grow with the chains."""
    import torch

    from onix_torch.config import LDAConfig
    from onix_torch.corpus import synthetic_lda_corpus
    from onix_torch.models.lda_gibbs import GibbsLDA, TorchNoise, block_step
    corpus, _, _ = synthetic_lda_corpus(MAIN_D, MAIN_V, MAIN_K,
                                        mean_doc_len=97, seed=5)
    per_step = {}
    for chains in (1, 8):
        tag = f"fit profile C={chains}"
        model = GibbsLDA(LDAConfig(n_sweeps=2, burn_in=0, n_chains=chains),
                         corpus.n_docs, corpus.n_vocab, device="cuda")
        model.fit(corpus, n_sweeps=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.fit(corpus)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        dev = sorted(((ms, count, key) for key, count, ms
                      in device_events(lambda: model.fit(corpus))),
                     reverse=True)
        busy = sum(ms for ms, _, _ in dev)
        docs, words, mask = model.prepare(corpus)
        n_steps = 2 * docs.shape[0]
        say(card, f"{tag}: {corpus.n_tokens} tokens, 2 sweeps "
                  f"({n_steps} block steps), wall {wall * 1e3:.1f} ms "
                  f"unprofiled, {corpus.n_tokens * 2 * chains / wall:.4g} "
                  f"chain-tokens/s; device busy {busy:.1f} ms (profiled "
                  f"run); {sum(c for _, c, _ in dev) / n_steps:.2f} device "
                  f"ops a block step over the whole fit")
        for ms, count, key in dev[:6]:
            say(card, f"{tag}:   {ms:9.3f} ms  x{count:<6d} {key[:60]}")
        # The block step alone, and the noise draw that feeds it.
        cfg = model.config
        st = model.fit(corpus, n_sweeps=1)["state"]
        noise = TorchNoise(9, "cuda", n_chains=chains)
        nb, b = docs.shape
        blocks = [noise.block(b, MAIN_K, True) for _ in range(nb)]

        def draws():
            for _ in range(nb):
                noise.block(b, MAIN_K, True)

        def steps():
            for i in range(nb):
                block_step(st, i, docs[i], words[i], mask[i], blocks[i],
                           alpha=cfg.alpha, eta=cfg.eta,
                           v_eta=corpus.n_vocab * cfg.eta, use_gumbel=True)
        total = 0.0
        for label, fn in (("noise draw", draws), ("block step", steps)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            host = time.perf_counter() - t0
            torch.cuda.synchronize()
            done = time.perf_counter() - t0
            ops = [(c, k, ms) for k, c, ms in most_launches(fn)]
            per = sum(c for c, _, _ in ops) / nb
            total += per
            say(card, f"{tag}: {label}: {per:.2f} device launches a "
                      f"block step ({'; '.join(k[:40] for _, k, _ in ops)}"
                      f"); device {sum(t for _, _, t in ops) / nb:.4f} ms, "
                      f"host enqueue {host / nb * 1e3:.4f} ms, to done "
                      f"{done / nb * 1e3:.4f} ms a block step "
                      f"(unprofiled, {nb} steps)")
            if label == "block step" and per != 2:
                raise AssertionError("the fit's block step is not the two "
                                     "K1 kernels alone")
        per_step[chains] = total
    if per_step[8] != per_step[1]:
        raise AssertionError(f"device launches a block step grew with the "
                             f"chains: {per_step}")


# -- phase 5 ----------------------------------------------------------------

def phase_slice(card: str, root: pathlib.Path, chains: int = 1):
    """Write the day into a store under `root` and run `onix_torch
    score` on it with serving.save_fitted on, so the day's model lands
    under <root>/models for the serving phase; with `chains` > 1 the
    run adds `-s lda.n_chains=<chains>` and K1's launches must stay
    those of one chain. Returns the K1 launch count, the day's table,
    its planted anomalies and their recall."""
    import numpy as np
    import pandas as pd
    import torch

    from onix_torch import cli
    from onix_torch.models import sample_count
    from onix_torch.pipelines.synth import synth_flow_day
    from onix_torch.store import Store
    date = "2016-07-08"
    t0 = time.perf_counter()
    table, planted = synth_flow_day(DAY_EVENTS, n_hosts=DAY_HOSTS,
                                    n_anomalies=DAY_ANOMALIES, seed=0)
    Store(root).write("flow", date, table)
    tag = "slice" if chains == 1 else f"slice C={chains}"
    say(card, f"{tag}: synthetic day of {len(table)} events written "
              f"in {time.perf_counter() - t0:.2f} s")
    torch.cuda.synchronize()
    sample_count.launches = 0
    t0 = time.perf_counter()
    rc = cli.main(["score", date, "flow", "-s", f"store.root={root}",
                   "-s", "serving.save_fitted=true",
                   "-s", f"lda.n_chains={chains}"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = sample_count.launches
    if rc != 0:
        raise AssertionError(f"onix_torch score exited {rc}")
    out = root / "results" / "20160708"
    csv = out / "flow_results.csv"
    man_path = out / "flow_results.manifest.json"
    for p in (csv, man_path, out / "flow_results_clients.csv"):
        if not p.exists():
            raise AssertionError(f"missing output {p.name}")
    man = json.loads(man_path.read_text())
    stages = {}
    for line in (out / "flow_results.runlog.jsonl").read_text() \
            .splitlines():
        rec = json.loads(line)
        if rec["event"] == "stage_end":
            stages[rec["stage"]] = rec["wall_s"]
    res = pd.read_csv(csv)
    n_tok = man["n_tokens"]
    want = 60 * math.ceil(n_tok / 65_536)
    if launches != want or man["kernel_launches"]["sample_count"] != want:
        raise AssertionError(
            f"K1 launched {launches} times (manifest "
            f"{man['kernel_launches']}), want 60 x ceil({n_tok} / 65536)"
            f" = {want}")
    scores = res["score"].to_numpy()
    if not (len(res) and np.isfinite(scores).all()
            and (scores < 1.1).all() and (np.diff(scores) >= 0).all()):
        raise AssertionError("results are not finite ascending scores "
                             "under tol")
    lls = [ll for _, ll in man["ll_history"]]
    if not (np.isfinite(lls).all() and lls[-1] > lls[0]):
        raise AssertionError(f"ll_history did not rise: {lls}")
    recall = len(set(res["event_idx"]) & set(planted.tolist())) / len(
        planted)
    fit_s = stages["lda_fit"]
    saved = pathlib.Path(man.get("model_saved", ""))
    if not saved.exists():
        raise AssertionError("score did not save the fitted model")
    with np.load(saved) as z:
        theta_shape = tuple(z["theta"].shape)
    lead = (chains,) if chains > 1 else ()
    if theta_shape != (*lead, man["n_docs"], MAIN_K):
        raise AssertionError(f"saved theta has shape {theta_shape}")
    say(card, f"{tag}: onix_torch score {date} flow -s lda.n_chains="
              f"{chains}: D={man['n_docs']} V={man['n_vocab']} N={n_tok}, "
              f"device {man['device']}, K1 launches {launches}, saved "
              f"theta {theta_shape}")
    say(card, f"{tag}: wall {wall:.2f} s; stages {json.dumps(stages)}; "
              f"fit {fit_s:.2f} s = {n_tok * 60 / fit_s:.4g} tokens/s, "
              f"{n_tok * 60 * chains / fit_s:.4g} chain-tokens/s (60 "
              f"sweeps); scoring {man['scoring_seconds']} s "
              f"({man['events_per_sec']} events/s)")
    say(card, f"{tag}: planted-anomaly recall {recall:.4f} "
              f"({len(res)} results, bar {RECALL_BAR}); ll "
              f"{lls[0]:.5f} -> {lls[-1]:.5f}")
    if recall < RECALL_BAR:
        raise AssertionError(f"recall {recall} under {RECALL_BAR}")
    return {"sample_count": launches}, table, planted, recall


# -- phase 6 ----------------------------------------------------------------

def http_json(port: int, method: str, path: str, obj=None,
              want: int = 200):
    """One request to the local server; raises unless it answers
    `want`. Returns (decoded JSON body, seconds)."""
    import http.client
    body = None if obj is None else json.dumps(obj)
    t0 = time.perf_counter()
    with bounded("HTTP request", f"{method} {path}") as lim:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=lim)
        try:
            conn.request(method, path, body=body,
                         headers={"Content-Type": "application/json"})
            r = conn.getresponse()
            data = r.read()
        finally:
            conn.close()
    wall = time.perf_counter() - t0
    if r.status != want:
        raise AssertionError(f"{method} {path} answered {r.status}, want "
                             f"{want}: {data[:300]!r}")
    return (json.loads(data) if path != "/metrics" else data.decode()), wall


def day_requests(table, dupfactor: int):
    """The day tenant's tokens in the fitted model's ids, and the hour of
    each: the corpus the score run fitted on, rebuilt from the day."""
    import numpy as np
    import pandas as pd

    from onix_torch.pipelines.corpus_build import build_corpus
    from onix_torch.pipelines.words import WORD_FNS
    bundle = build_corpus(WORD_FNS["flow"](table), None, dupfactor)
    n = bundle.n_real_tokens
    d = bundle.corpus.doc_ids[:n].astype(np.int32)
    w = bundle.corpus.word_ids[:n].astype(np.int32)
    hour = pd.to_datetime(table["treceived"]).dt.hour.to_numpy()
    return d, w, hour[bundle.token_event[:n]], bundle


def write_harness_tenants(models_dir, seed: int) -> dict:
    """The load harness's acceptance class (onix/serving/load_harness.py
    `make_tenants`): Dirichlet(0.5) rows, D = 2,048, V = 1,024, K = 20,
    saved with the port's save_model. Returns {name: (theta, phi)}."""
    import numpy as np

    from onix_torch.checkpoint import save_model
    from onix_torch.store import model_name
    rng = np.random.default_rng(seed)
    out = {}
    for t in range(HARNESS_TENANTS):
        theta = rng.dirichlet(np.full(HARNESS_K, 0.5),
                              size=HARNESS_D).astype(np.float32)
        phi = rng.dirichlet(np.full(HARNESS_K, 0.5),
                            size=HARNESS_V).astype(np.float32)
        name = model_name("flow", HARNESS_DATE, f"t{t:04d}")
        save_model(models_dir, name, theta, phi)
        out[name] = (theta, phi)
    return out


SERVE_SPANS = ("serve.request", "serve.submit", "serve.score", "bank.admit",
               "bank.score_wave")


def span_breakdown(card: str, label: str) -> None:
    """Print the wall seconds each serving span (utils/telemetry.py)
    summed since the last call, then clear the span histograms:
    serve.request is the whole HTTP handler, serve.score the bank's
    part of it, bank.admit the slot admission and copy to the card,
    bank.score_wave staging, the K2 launch and the winner fetch."""
    from onix_torch.utils import telemetry
    parts = []
    for name in SERVE_SPANS:
        h = telemetry.histograms.get("span." + name)
        if h is not None and h.n:
            parts.append(f"{name} {h.sum:.4f} s x{h.n}")
    say(card, f"serve: {label}: spans (summed wall): {', '.join(parts)}")
    telemetry.histograms.reset()


def check_winners(res: dict, want, what: str) -> None:
    """A /score result against a TopK from the plain path: scores,
    indices and order bit for bit (+inf travels as null)."""
    import numpy as np
    scores = np.array([np.inf if s is None else s for s in res["scores"]],
                      np.float32)
    idx = np.asarray(res["indices"], np.int32)
    if not (np.array_equal(idx, want.indices.cpu().numpy())
            and np.array_equal(scores, want.scores.cpu().numpy())):
        bad = int((idx != want.indices.cpu().numpy()).sum())
        raise AssertionError(f"serve: {what}: winners differ from the "
                             f"plain single-tenant path at {bad} slots")


def phase_serve(card: str, root: pathlib.Path, table) -> dict:
    """Serve the saved day model and 63 harness tenants from one bank on
    the card through a real `serve_background`, drive /score, the whole
    day through BankService.submit, one wave at M = 100,000, /feedback
    and /score again; hold every answer to the plain single-tenant
    path; check K2's launches against the bank's dispatches."""
    import numpy as np
    import torch

    from onix_torch.checkpoint import load_model
    from onix_torch.config import OnixConfig
    from onix_torch.feedback.filter import filter_from_csv
    from onix_torch.models import fused_serve, scoring
    from onix_torch.oa.serve import serve_background
    from onix_torch.serving.model_bank import ScoreRequest
    from onix_torch.store import feedback_path, model_name
    from onix_torch.utils import telemetry
    from onix_torch.utils.obs import counters
    cfg = OnixConfig()
    cfg.store.root = str(root)
    # Pinned: this phase counts K2's launches against the bank's waves.
    cfg.serving.serve_form = "fused"
    cfg.validate()
    tol, m = cfg.pipeline.tol, cfg.pipeline.max_results
    day = model_name("flow", SERVE_DATE)
    saved = load_model(cfg.serving.models_dir, day)
    d_all, w_all, hour, bundle = day_requests(table, cfg.pipeline.dupfactor)
    if saved.arrays["theta"].shape[0] != bundle.corpus.n_docs \
            or saved.arrays["phi_wk"].shape[0] != bundle.corpus.n_vocab:
        raise AssertionError("the rebuilt corpus does not match the saved "
                             "model's ids")
    harness = write_harness_tenants(cfg.serving.models_dir, seed=3)
    dev = "cuda"
    tables = {day: tuple(torch.from_numpy(saved.arrays[k]).to(dev)
                         for k in ("theta", "phi_wk"))}
    tables.update({n: tuple(torch.from_numpy(a).to(dev) for a in tp)
                   for n, tp in harness.items()})

    def oracle(tenant, d, w, max_results=m):
        th, ph = tables[tenant]
        return scoring.top_suspicious(
            th, ph, torch.from_numpy(d).to(dev), torch.from_numpy(w).to(dev),
            torch.ones(len(d), device=dev), tol=tol,
            max_results=max_results)

    hours = [(f"h{h:02d}", d_all[hour == h], w_all[hour == h])
             for h in range(24)]
    rng = np.random.default_rng(4)
    ranks = (rng.zipf(ZIPF_A, HARNESS_REQUESTS) - 1) % HARNESS_TENANTS
    names = sorted(harness)
    harness_reqs = [(names[int(t)],
                     rng.integers(0, HARNESS_D, HARNESS_EVENTS)
                     .astype(np.int32),
                     rng.integers(0, HARNESS_V, HARNESS_EVENTS)
                     .astype(np.int32))
                    for t in (ranks * 2654435761) % HARNESS_TENANTS]

    def body(reqs, tenant=None, **kw):
        return {"requests": [{"tenant": tenant or r[0], "window": r[0]
                              if tenant else None,
                              "doc_ids": r[1].tolist(),
                              "word_ids": r[2].tolist()} for r in reqs],
                **kw}

    torch.cuda.synchronize()
    fused_serve.launches = 0
    server, port = serve_background(cfg)
    telemetry.histograms.reset()
    try:
        out, wall = http_json(port, "POST", "/score", body(hours, day))
        span_breakdown(card, "day batch")
        n_ev = sum(len(r[1]) for r in hours)
        say(card, f"serve: day tenant, 24 hourly requests, {n_ev} events "
                  f"(one wave; the longest request "
                  f"{max(len(r[1]) for r in hours)} events): "
                  f"/score wall {wall:.3f} s, {n_ev / wall:.4g} events/s")
        for (win, d, w), res in zip(hours, out["results"]):
            check_winners(res, oracle(day, d, w), f"{day} {win}")
        h05 = out["results"][5]

        out, wall = http_json(port, "POST", "/score", body(harness_reqs))
        span_breakdown(card, "harness batch")
        n_ev = HARNESS_REQUESTS * HARNESS_EVENTS
        say(card, f"serve: {HARNESS_REQUESTS} harness requests over "
                  f"{len(set(r[0] for r in harness_reqs))} tenants, "
                  f"{n_ev} events: /score wall {wall:.3f} s, "
                  f"{n_ev / wall:.4g} events/s")
        for (t, d, w), res in zip(harness_reqs, out["results"]):
            check_winners(res, oracle(t, d, w), t)
        # The same batch again, every tenant resident now and no
        # window to cache on: a warm wave.
        out, wall = http_json(port, "POST", "/score", body(harness_reqs))
        span_breakdown(card, "harness batch, warm")
        say(card, f"serve: the harness batch again, warm: /score wall "
                  f"{wall:.3f} s, {n_ev / wall:.4g} events/s")
        for (t, d, w), res in zip(harness_reqs, out["results"]):
            check_winners(res, oracle(t, d, w), t)

        service = server.peek_bank_service()
        t0 = time.perf_counter()
        (whole,) = service.submit([ScoreRequest(day, d_all, w_all, "day")],
                                  tol=tol, max_results=m)
        wall = time.perf_counter() - t0
        span_breakdown(card, "whole day")
        say(card, f"serve: the whole day, {len(d_all)} events as one "
                  f"request through BankService.submit: wall {wall:.3f} s, "
                  f"{len(d_all) / wall:.4g} events/s")
        check_winners({"scores": whole.topk.scores.tolist(),
                       "indices": whole.topk.indices.tolist()},
                      oracle(day, d_all, w_all), "whole day")

        out, wall = http_json(port, "POST", "/score",
                              body(hours[:1], day, max_results=100_000))
        say(card, f"serve: {day} h00 at max_results 100000: /score wall "
                  f"{wall:.3f} s")
        check_winners(out["results"][0],
                      oracle(day, hours[0][1], hours[0][2], 100_000),
                      "h00 at M=100000")

        # Feedback: three winners of h05 benign, one a threat.
        _, d5, w5 = hours[5]
        pairs = []
        for i in h05["indices"]:
            p = (int(d5[i]), int(w5[i]))
            if p not in pairs:
                pairs.append(p)
            if len(pairs) == 4:
                break
        threat = next(i for i in h05["indices"]
                      if (int(d5[i]), int(w5[i])) == pairs[3])
        s_threat = h05["scores"][h05["indices"].index(threat)]
        epoch0 = service.bank.epoch(day)
        rows = [{"ip": f"doc{dd}", "word": f"word{ww}",
                 "label": 3 if k < 3 else 1, "doc_id": dd, "word_id": ww}
                for k, (dd, ww) in enumerate(pairs)]
        fb, _ = http_json(port, "POST", "/feedback", {
            "datatype": "flow", "date": SERVE_DATE, "rows": rows})
        if not (fb["ok"] and fb["model_epoch"] > epoch0):
            raise AssertionError(f"feedback did not move the epoch: {fb}")
        again, wall = http_json(port, "POST", "/score",
                                body(hours[5:6], day))
        res = again["results"][0]
        alive = {(int(d5[i]), int(w5[i])) for i in res["indices"] if i >= 0}
        pos = res["indices"].index(threat) if threat in res["indices"] \
            else None
        if res["cached"] or alive & set(pairs[:3]) or pos is None \
                or res["scores"][pos] != float(np.float32(s_threat)
                                               * np.float32(0.25)):
            raise AssertionError("feedback was not applied as labeled")
        filt = filter_from_csv(
            feedback_path(cfg.store.feedback_dir, "flow", SERVE_DATE),
            cfg.feedback.boost_scale).tables(device=dev)
        th, ph = tables[day]
        want = fused_serve.fused_call_plain(
            (th, ph, torch.from_numpy(d5).to(dev),
             torch.from_numpy(w5).to(dev)),
            torch.ones(len(d5), device=dev), None, None, filt, tol,
            mode="dot", max_results=m)
        check_winners(res, want, "h05 after feedback")
        third, _ = http_json(port, "POST", "/score", body(hours[5:6], day))
        if not third["results"][0]["cached"]:
            raise AssertionError("a repeat after feedback was not cached")
        say(card, f"serve: feedback: epoch {epoch0} -> {fb['model_epoch']}, "
                  f"h05 re-scored in {wall:.3f} s without the 3 benign "
                  f"pairs, the threat kept at score x 0.25, repeat cached")

        stats, _ = http_json(port, "GET", "/bank/stats")
        metrics, _ = http_json(port, "GET", "/metrics")
    finally:
        server.shutdown()
        server.server_close()
    torch.cuda.synchronize()
    launches = fused_serve.launches
    bank = service.bank
    if not (launches == bank.dispatches == stats["dispatches"]
            and launches > 0):
        raise AssertionError(f"K2 launched {launches} times, the bank "
                             f"dispatched {bank.dispatches} waves")
    if counters.get("serve.form_fallback") or bank.fallback_dispatches \
            or stats["admission"]["form_fallback"]:
        raise AssertionError("a serving wave fell back")
    if "onix_bank_dispatch_count" not in metrics:
        raise AssertionError("/metrics lacks the bank gauges")
    say(card, f"serve: K2 launches {launches} = bank dispatches; "
              f"form fallbacks 0; tiers {json.dumps(stats['tiers']['hbm'])}")
    return {"fused_serve": launches}


# -- phase 7 ----------------------------------------------------------------

# The reference's recipe for each datatype's judged cell
# (docs/OVERLAP_r03.json, seed 5): (datatype, chains, oracle restarts,
# sweeps, then the JAX engine's overlap vs the oracle and the oracle's
# ceiling on the day today's generator makes, from
# `python -m onix.pipelines.rehearsal` at the same recipe on a CPU host;
# r03's figures came from an older day).
OVERLAP_CELLS = [
    ("flow", 8, 16, 300, 0.973, 0.972),
    ("dns", 16, 32, 400, 0.964, 0.967),
    ("proxy", 16, 32, 400, 0.967, 0.970),
]
OVERLAP_EVENTS, OVERLAP_SEED = 100_000, 5
# A host of this many cores runs the dns and proxy cells side by side.
OVERLAP_SIDE_BY_SIDE_CPUS = 16
# The rehearsal process's niceness: the phases beside it keep the cores.
OVERLAP_NICE = 10
# The file lock that the kernel timings and the rehearsal's fits share.
TIMING_LOCK = {"path": None}


def timing_lock():
    """While held, no fit of phase 7's rehearsal process runs on the
    card: the script's kernel timings (`event_ms`, `device_events`) and
    the rehearsal's fits take one file lock (TIMING_LOCK), so the card
    times a kernel alone. A no-op before phase 7 starts."""
    if TIMING_LOCK["path"] is None:
        return contextlib.nullcontext()
    return _flocked(TIMING_LOCK["path"])


@contextlib.contextmanager
def _flocked(path: str):
    import fcntl
    with open(path, "a") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


def rehearsal_child(out_path: str, lock_path: str) -> None:
    """Phase 7's cells in a child process (`python -c "import chip_smoke;
    chip_smoke.rehearsal_child(out, lock)"`), niced so that the phases
    beside it keep the host's cores: the port's `run_rehearsal` for
    each datatype at the reference's recipe (100,000 events, K 20,
    alpha 0.5, eta 0.05, seed 5), the chains fitted on the card (under
    the timing lock) against oracle restart ensembles on the host's
    cores. On a host of at least OVERLAP_SIDE_BY_SIDE_CPUS cores the
    dns and proxy cells run side by side, 8 threads each. Writes
    {datatype: [result, wall seconds, threads]}, the core count and the
    child's own wall from its start."""
    from concurrent.futures import ThreadPoolExecutor
    t_child = time.perf_counter()

    from onix_torch.models import lda_gibbs
    from onix_torch.pipelines.rehearsal import run_rehearsal
    os.nice(OVERLAP_NICE)
    fit = lda_gibbs.GibbsLDA.fit

    def locked_fit(model, *a, **kw):
        with _flocked(lock_path):
            return fit(model, *a, **kw)
    lda_gibbs.GibbsLDA.fit = locked_fit
    cpus = os.cpu_count() or 1
    side = cpus >= OVERLAP_SIDE_BY_SIDE_CPUS

    def cell(dt, chains, runs, sweeps, workers):
        t0 = time.perf_counter()
        r = run_rehearsal(n_events=OVERLAP_EVENTS, n_sweeps=sweeps,
                          n_chains=chains, n_oracle_runs=runs, n_topics=20,
                          alpha=0.5, eta=0.05, seed=OVERLAP_SEED,
                          datatype=dt, device="cuda", workers=workers)
        return [r, time.perf_counter() - t0, workers]

    got = {}
    for dt, chains, runs, sweeps, _, _ in (OVERLAP_CELLS[:1] if side
                                           else OVERLAP_CELLS):
        got[dt] = cell(dt, chains, runs, sweeps, cpus)
    if side:
        with ThreadPoolExecutor(max_workers=2) as pool:
            futs = {dt: pool.submit(cell, dt, chains, runs, sweeps, 8)
                    for dt, chains, runs, sweeps, _, _ in OVERLAP_CELLS[1:]}
            got.update({dt: f.result() for dt, f in futs.items()})
    pathlib.Path(out_path).write_text(json.dumps({
        "cpus": cpus, "cells": got,
        "wall_s": time.perf_counter() - t_child}))


def start_overlap(root: pathlib.Path) -> tuple:
    """Start phase 7's rehearsal process beside the later phases; from
    here on the kernel timings take the timing lock. Returns what
    `finish_overlap` needs."""
    out = root / "overlap.json"
    TIMING_LOCK["path"] = str(root / "timing.lock")
    proc = subprocess.Popen(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "chip_smoke.rehearsal_child(sys.argv[1], sys.argv[2])",
         str(out), TIMING_LOCK["path"]],
        cwd=str(HERE), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    return proc, out, time.perf_counter()


def finish_overlap(card: str, proc, out: pathlib.Path, t0: float) -> dict:
    """Wait for phase 7's rehearsal process and hold each cell to the
    judged bar: top-1k overlap >= 0.95 and >= the oracle's own ceiling
    less 0.02, as tests/test_oracle.py holds the JAX engine. Returns
    the cells' results by datatype."""
    from onix_torch.pipelines.rehearsal import JUDGED_BAR
    PHASE["n"] = 7
    try:
        with bounded("overlap process", "phase 7's rehearsal process") \
                as lim:
            log, _ = proc.communicate(
                timeout=max(1.0, lim - (time.perf_counter() - t0)))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    joined = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"overlap: the rehearsal process exited "
                             f"{proc.returncode}:\n{log[-3000:]}")
    got = json.loads(out.read_text())
    say(card, f"overlap: a child process, niced {OVERLAP_NICE}, beside "
              f"phases 5-16; the host has {got['cpus']} cores: dns and "
              "proxy " + ("side by side, 8 threads each"
                          if got["cpus"] >= OVERLAP_SIDE_BY_SIDE_CPUS else
                          "one after the other"))
    res = {}
    for dt, chains, runs, sweeps, ref, ref_ceiling in OVERLAP_CELLS:
        r, cell_wall, threads = got["cells"][dt]
        say(card, f"overlap {dt}: {chains} chains on the card vs oracle "
                  f"ens-{runs} ({threads} threads), {sweeps} sweeps, seed "
                  f"{OVERLAP_SEED}: port_vs_oracle {r['port_vs_oracle']} "
                  f"(the JAX engine {ref}), oracle ceiling "
                  f"{r['oracle_vs_oracle']} (the reference's run "
                  f"{ref_ceiling}); {cell_wall:.1f} s")
        say(card, f"overlap {dt}: {json.dumps(r)}")
        if not (r["port_vs_oracle"] >= JUDGED_BAR
                and r["port_vs_oracle"] >= r["oracle_vs_oracle"] - 0.02):
            raise AssertionError(
                f"overlap {dt}: port_vs_oracle {r['port_vs_oracle']} under "
                f"{JUDGED_BAR} or under the ceiling "
                f"{r['oracle_vs_oracle']} less 0.02")
        res[dt] = r
    PHASE_WALLS["7"] = round(got["wall_s"], 1)
    say(card, f"phase 7 passed in {PHASE_WALLS['7']} s (its process, "
              f"beside phases 5-16; joined {joined:.1f} s after its "
              "start)")
    return res


# -- phase 8 ----------------------------------------------------------------

# The drill on the phase-5 day (60 sweeps, superstep 10): checkpoints
# at sweeps 9, 19 and 29, the third save torn; the preemption fires at
# the first boundary at or after sweep 25, which is 29. The rerun
# resumes from 19.
DRILL_PLAN = "fit:sweep@25=preempt,ckpt:save@3=torn"
DRILL_EVERY, DRILL_STOP, DRILL_RESUME = 10, 29, 19
# The columnar day: the auto threshold (COLUMNAR_AUTO_MIN_ROWS) in 4
# parts of one Store.append each.
COLUMNAR_EVENTS, COLUMNAR_PARTS = 2_000_000, 4


def day_outputs(results_dir: pathlib.Path) -> dict:
    """What a `score` run of the flow day left under `results_dir`: the
    bytes of its results and clients CSVs, its manifest, run log records
    and, when it saved one, its model's theta/phi."""
    import numpy as np
    out = results_dir / "20160708"
    man = json.loads((out / "flow_results.manifest.json").read_text())
    got = {"results": (out / "flow_results.csv").read_bytes(),
           "clients": (out / "flow_results_clients.csv").read_bytes(),
           "manifest": man,
           "runlog": [json.loads(line) for line in
                      (out / "flow_results.runlog.jsonl").read_text()
                      .splitlines()]}
    if "model_saved" in man:
        with np.load(man["model_saved"]) as z:
            got["theta"], got["phi_wk"] = z["theta"], z["phi_wk"]
    return got


def rss_gib() -> float:
    """This process's resident size, GiB (/proc/self/statm)."""
    import os
    pages = int(pathlib.Path("/proc/self/statm").read_text().split()[1])
    return pages * os.sysconf("SC_PAGE_SIZE") / 2 ** 30


class PeakRss:
    """The peak resident size of this process while the block runs,
    sampled every 5 ms by a thread: the card's host reports no VmHWM,
    and a high-water mark would hold the earlier phases' peak too."""

    def __enter__(self):
        import threading
        self.before = self.peak = rss_gib()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _sample(self) -> None:
        while not self._stop.wait(0.005):
            self.peak = max(self.peak, rss_gib())

    def __exit__(self, *exc):
        self._stop.set()
        with bounded("RSS sampler join", "the RSS sampler thread") as lim:
            self._thread.join(timeout=lim)
            if self._thread.is_alive():
                raise TimeoutError("the sampler is still running")
        self.peak = max(self.peak, rss_gib())
        return False


def small_day(card: str, root: pathlib.Path) -> tuple:
    """The small day (SMALL_EVENTS) written into a store under `root`
    and scored once, uninterrupted, at the default config with
    serving.save_fitted on: K1's launches 60 x ceil(N / 65,536). Returns
    (its table, its planted anomalies, the run's outputs)."""
    import pandas as pd
    import torch

    from onix_torch import cli
    from onix_torch.models import sample_count
    from onix_torch.pipelines.synth import synth_flow_day
    from onix_torch.store import Store
    t0 = time.perf_counter()
    table, planted = synth_flow_day(SMALL_EVENTS, n_hosts=SMALL_HOSTS,
                                    n_anomalies=SMALL_ANOMALIES, seed=0)
    Store(root).write("flow", "2016-07-08", table)
    torch.cuda.synchronize()
    sample_count.launches = 0
    rc = cli.main(["score", "2016-07-08", "flow", "-s",
                   f"store.root={root}", "-s", "serving.save_fitted=true",
                   "-s", "lda.n_chains=1"])
    torch.cuda.synchronize()
    if rc != 0:
        raise AssertionError(f"small day: onix_torch score exited {rc}")
    got = day_outputs(root / "results")
    man = got["manifest"]
    check_launches("small day: K1", sample_count.launches,
                   60 * math.ceil(man["n_tokens"] / 65_536))
    res = pd.read_csv(root / "results" / "20160708" / "flow_results.csv")
    recall = len(set(res["event_idx"]) & set(planted.tolist())) / len(
        planted)
    say(card, f"small day: {len(table)} events, {SMALL_HOSTS} hosts, "
              f"{len(planted)} planted: D={man['n_docs']} V={man['n_vocab']}"
              f" N={man['n_tokens']}, K1 launches {sample_count.launches}; "
              f"wall {time.perf_counter() - t0:.2f} s with its synthesis; "
              f"recall {recall:.4f}; final ll {man['ll_history'][-1][1]:.5f}")
    return table, planted, got


def phase_resilience(card: str, root: pathlib.Path, small,
                     small_clean: dict) -> None:
    """The preemption drill on the small day (`small_clean` is what an
    uninterrupted `score` of it left) and the columnar day; see the
    module docstring."""
    import numpy as np
    import torch

    from onix_torch import cli
    from onix_torch.checkpoint import SimulatedPreemption
    from onix_torch.models import sample_count
    from onix_torch.pipelines.synth import synth_flow_day
    from onix_torch.store import Store
    from onix_torch.utils import faults
    from onix_torch.utils.obs import counters
    date = "2016-07-08"
    clean = small_clean
    n_tok = clean["manifest"]["n_tokens"]
    n_blocks = math.ceil(n_tok / 65_536)
    drill = root / "drill"
    Store(drill).write("flow", date, small)
    for prefix in ("salvage", "faults", "ckpt"):
        counters.reset(prefix)
    args = ["score", date, "flow", "-s", f"store.root={drill}",
            "-s", "serving.save_fitted=true", "-s", "lda.n_chains=1",
            "-s", f"lda.checkpoint_every={DRILL_EVERY}"]
    torch.cuda.synchronize()
    sample_count.launches = 0
    t0 = time.perf_counter()
    try:
        cli.main(args + ["--fault-plan", DRILL_PLAN])
    except SimulatedPreemption as e:
        preempted = str(e)
    else:
        raise AssertionError("the drill's run was not preempted")
    torch.cuda.synchronize()
    wall1 = time.perf_counter() - t0
    launches1 = sample_count.launches
    if launches1 != (DRILL_STOP + 1) * n_blocks:
        raise AssertionError(f"drill: K1 launched {launches1} times before "
                             f"the preemption, want {DRILL_STOP + 1} x "
                             f"{n_blocks}")
    (fp_dir,) = (drill / "checkpoints" / "flow" / "20160708").iterdir()
    on_disk = sorted(p.name for p in fp_dir.glob("ckpt-*"))
    torn = f"ckpt-{DRILL_STOP:06d}"
    if f"{torn}.npz" not in on_disk or f"{torn}.json" in on_disk:
        raise AssertionError(f"drill: no torn sweep-{DRILL_STOP} pair: "
                             f"{on_disk}")
    say(card, f"drill: the small day ({len(small)} events, {n_blocks} "
              f"blocks) preempted ({preempted}) after {wall1:.2f} s, K1 "
              f"launches {launches1}; on disk {on_disk}")
    faults.reset()
    torch.cuda.synchronize()
    sample_count.launches = 0
    t0 = time.perf_counter()
    rc = cli.main(args)
    torch.cuda.synchronize()
    wall2 = time.perf_counter() - t0
    launches2 = sample_count.launches
    if rc != 0:
        raise AssertionError(f"drill: the rerun exited {rc}")
    got = day_outputs(drill / "results")
    man = got["manifest"]
    want2 = (60 - DRILL_RESUME - 1) * n_blocks
    if launches2 != want2 or man["kernel_launches"]["sample_count"] != want2:
        raise AssertionError(f"drill: the rerun launched K1 {launches2} "
                             f"times, want {want2}")
    ck = man["checkpoint"]
    if ck["resumed_from"] != DRILL_RESUME \
            or man["ll_history"][0][0] != DRILL_RESUME:
        raise AssertionError(f"drill: resumed from {ck['resumed_from']}, "
                             f"want {DRILL_RESUME}")
    for key in ("results", "clients"):
        if got[key] != clean[key]:
            raise AssertionError(f"drill: the {key} CSV differs from the "
                                 "uninterrupted day's")
    for key in ("theta", "phi_wk"):
        if not np.array_equal(got[key], clean[key]):
            raise AssertionError(f"drill: the saved {key} differs from the "
                                 "uninterrupted day's")
    if man.get("resilience") != {"faults.ckpt.save": 1,
                                 "faults.fit.sweep": 1}:
        raise AssertionError(f"drill: resilience {man.get('resilience')}")
    saves = ck["save_s"]
    say(card, f"drill: rerun {wall2:.2f} s, K1 launches {launches2}, "
              f"resumed from sweep {ck['resumed_from']}; results, clients "
              f"and theta/phi equal the uninterrupted run's; resilience "
              f"{man['resilience']}")
    say(card, f"drill: checkpoint load (resume) {ck['load_s']:.6f} s; "
              f"{len(saves)} saves {[round(x, 6) for x in saves]} s, median "
              f"{statistics.median(saves):.6f} s; one checkpoint's npz "
              f"{max(p.stat().st_size for p in fp_dir.glob('*.npz')) / 2 ** 20:.2f}"
              " MiB")

    # The columnar day.
    col = root / "columnar"
    t0 = time.perf_counter()
    big, _ = synth_flow_day(COLUMNAR_EVENTS, n_hosts=2 * DAY_HOSTS,
                            n_anomalies=2 * DAY_ANOMALIES, seed=1)
    step = COLUMNAR_EVENTS // COLUMNAR_PARTS
    for i in range(COLUMNAR_PARTS):
        Store(col).append("flow", date, big.iloc[i * step:(i + 1) * step])
    del big
    say(card, f"columnar: a day of {COLUMNAR_EVENTS} events in "
              f"{COLUMNAR_PARTS} parts written in "
              f"{time.perf_counter() - t0:.2f} s")
    runs = {}
    for mode in ("auto", "off"):
        torch.cuda.synchronize()
        sample_count.launches = 0
        t0 = time.perf_counter()
        with PeakRss() as rss:
            rc = cli.main(["score", date, "flow", "-s", f"store.root={col}",
                           "-s", f"store.results_dir={col}/results-{mode}",
                           "-s", f"pipeline.columnar={mode}"])
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"columnar: the {mode} run exited {rc}")
        got = day_outputs(col / f"results-{mode}")
        runs[mode] = got
        man = got["manifest"]
        modes = [r["columnar"] for r in got["runlog"]
                 if r["event"] == "read_mode"]
        if modes != [mode == "auto"]:
            raise AssertionError(f"columnar: {mode} run read_mode {modes}")
        want = 60 * math.ceil(man["n_tokens"] / 65_536)
        if sample_count.launches != want \
                or man["kernel_launches"]["sample_count"] != want:
            raise AssertionError(
                f"columnar: the {mode} run launched K1 "
                f"{sample_count.launches} times, want {want}")
        stages = {r["stage"]: r["wall_s"] for r in got["runlog"]
                  if r["event"] == "stage_end"}
        say(card, f"columnar: {mode} (read_mode columnar={modes[0]}): wall "
                  f"{wall:.2f} s; read {stages['read']} s, word_creation "
                  f"{stages['word_creation']} s, corpus_build "
                  f"{stages['corpus_build']} s, lda_fit {stages['lda_fit']} "
                  f"s; K1 launches {want}; peak RSS {rss.peak:.3f} GiB "
                  f"during the run ({rss.before:.3f} GiB resident before "
                  f"it, sampled every 5 ms)")
    a, b = runs["auto"], runs["off"]
    for key in ("results", "clients"):
        if a[key] != b[key]:
            raise AssertionError(f"columnar: the {key} CSVs differ")
    for key in ("n_events", "n_docs", "n_vocab", "n_tokens", "n_results"):
        if a["manifest"][key] != b["manifest"][key]:
            raise AssertionError(f"columnar: {key} differs")
    m = a["manifest"]
    say(card, f"columnar: equal CSVs; n_events {m['n_events']}, D "
              f"{m['n_docs']}, V {m['n_vocab']}, N {m['n_tokens']}, "
              f"{m['n_results']} results")


# -- phase 9 ----------------------------------------------------------------

# The scale day: `run_scale` at the reference's defaults (K 20, block
# 2^17, 20 sweeps, M 3,000; n_hosts and the planted anomalies follow
# the event count, scale.py's `run_scale` and `_default_anomalies`).
SCALE_EVENTS, SCALE_TRAIN, SCALE_BLOCK, SCALE_M = (10_000_000, 2_000_000,
                                                   1 << 17, 3000)
# The reference's own bar for planted anomalies among the scale day's
# winners (tests/test_scale.py).
SCALE_PLANTED_BAR = 0.8


def check_launches(what: str, got: int, want: int) -> None:
    if got != want:
        raise AssertionError(f"{what}: {got} kernel launches, want {want}")


def phase_scale(card: str, root: pathlib.Path, table, planted,
                n_events: int = SCALE_EVENTS,
                n_train: int = SCALE_TRAIN) -> dict:
    """The scale day and the sharded engine on the card; see the module
    docstring. Returns the scale entries of the kernels line's rows, and
    (d)'s host words arm: its winners (event ids, scores) and its count
    of planted anomalies among them."""
    import os

    import numpy as np
    import pandas as pd
    import torch

    from onix_torch import cli
    from onix_torch.models import fused_serve as fs
    from onix_torch.models import sample_count, scoring
    from onix_torch.pipelines import scale
    from onix_torch.pipelines.corpus_build import select_suspicious_events
    from onix_torch.store import Store
    date = "2016-07-08"
    # (a) score --engine sharded on phase 5's day.
    day = root / "sharded"
    Store(day).write("flow", date, table)
    torch.cuda.synchronize()
    sample_count.launches = 0
    t0 = time.perf_counter()
    rc = cli.main(["score", date, "flow", "-s", f"store.root={day}",
                   "--engine", "sharded"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches_a = sample_count.launches
    if rc != 0:
        raise AssertionError(f"score --engine sharded exited {rc}")
    got = day_outputs(day / "results")
    man = got["manifest"]
    check_launches("score --engine sharded: K1", launches_a,
                   60 * math.ceil(man["n_tokens"] / 65_536))
    check_launches("score --engine sharded: K1 (manifest)",
                   man["kernel_launches"]["sample_count"], launches_a)
    res = pd.read_csv(day / "results" / "20160708" / "flow_results.csv")
    recall = len(set(res["event_idx"]) & set(planted.tolist())) / len(
        planted)
    stages = {r["stage"]: r["wall_s"] for r in got["runlog"]
              if r["event"] == "stage_end"}
    lls = [ll for _, ll in man["ll_history"]]
    say(card, f"scale (a): onix_torch score {date} flow --engine sharded: "
              f"engine {man['engine']}, D={man['n_docs']} V={man['n_vocab']} "
              f"N={man['n_tokens']}, K1 launches {launches_a}; wall "
              f"{wall:.2f} s; stages {json.dumps(stages)}; recall "
              f"{recall:.4f} (bar {RECALL_BAR}); ll {lls[0]:.5f} -> "
              f"{lls[-1]:.5f}")
    if recall < RECALL_BAR or not lls[-1] > lls[0]:
        raise AssertionError(f"score --engine sharded: recall {recall}, "
                             f"ll {lls[0]} -> {lls[-1]}")

    # (b) run_scale at the defaults; the resume dir keeps the model.
    resume = root / "scale_resume"
    torch.cuda.synchronize()
    sample_count.launches = fs.launches = 0
    t0 = time.perf_counter()
    with PeakRss() as rss, Calls(scale, "build_corpus") as built:
        m = scale.run_scale(n_events, resume_dir=str(resume),
                            out_path=root / "scale.json")
    wall = time.perf_counter() - t0
    launches_b = sample_count.launches
    want_b = 20 * math.ceil(m["n_train_tokens"] / SCALE_BLOCK)
    check_launches("run_scale: K1", launches_b, want_b)
    check_launches("run_scale: K1 (manifest)",
                   m["kernel_launches"]["sample_count"], want_b)
    # run_scale selects under "auto": one K2 launch when the serve gate
    # resolves "fused" at the day's N, none for the f32 scan.
    scan_form = fs.select_serve_form("auto", n_events, "cuda")
    check_launches(f"run_scale: K2 (auto resolves {scan_form})", fs.launches,
                   1 if scan_form == "fused" else 0)
    hits, n_planted = m["planted_in_bottom_k"], m["planted_anomalies"]
    say(card, f"scale (b): run_scale({n_events}): D={m['n_docs']} "
              f"V={m['n_vocab']} N={m['n_train_tokens']} n_hosts="
              f"{m['n_hosts']}, device {m['device']}, K1 launches "
              f"{launches_b}; walls {json.dumps(m['walls_seconds'])}; "
              f"the fit's {json.dumps(m['fit_walls_seconds'])}; "
              f"{m['events_per_second_end_to_end']} events/s end to end, "
              f"{m['events_per_second_pipeline_only']} events/s pipeline "
              f"only; wall {wall:.2f} s with the resume dir's saves; peak "
              f"RSS {rss.peak:.3f} GiB ({rss.before:.3f} before); planted "
              f"in the bottom {m['max_results']}: {hits} of {n_planted} "
              f"(bar {SCALE_PLANTED_BAR}); score range "
              f"{m['selected_score_range']}")
    if hits < SCALE_PLANTED_BAR * n_planted:
        raise AssertionError(f"run_scale: {hits} of {n_planted} planted "
                             f"anomalies in the bottom-k, under "
                             f"{SCALE_PLANTED_BAR} of them")

    # (c) (b)'s model through the three selection arms.
    with np.load(resume / "model.npz") as z:
        theta, phi = z["theta"], z["phi_wk"]
    (_, _, bundle), = built.calls         # (b)'s own corpus of the day
    del built
    if bundle.corpus.n_tokens != m["n_train_tokens"]:
        raise AssertionError(f"scale (c): (b)'s corpus has "
                             f"{bundle.corpus.n_tokens} tokens, the manifest "
                             f"{m['n_train_tokens']}")
    arms = {}
    saved = {k: os.environ.get(k) for k in ("ONIX_SERVE_FORM",
                                            "ONIX_SCREENED_SELECT")}
    try:
        os.environ.pop("ONIX_SERVE_FORM", None)
        for arm, form, screened in (("xla", "xla", "0"),
                                    ("fused", "fused", "0"),
                                    ("screened", "xla", "1"),
                                    ("auto", "auto", "0")):
            os.environ["ONIX_SCREENED_SELECT"] = screened
            torch.cuda.synchronize()
            fs.launches = 0
            top = select_suspicious_events(bundle, theta, phi, n_events,
                                           tol=1.0, max_results=SCALE_M,
                                           serve_form=form)
            torch.cuda.synchronize()
            arms[arm] = (top, fs.launches)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    ref = arms["xla"][0]
    for arm, (top, n_k2) in arms.items():
        if not (torch.equal(top.indices, ref.indices)
                and torch.equal(top.scores, ref.scores)):
            raise AssertionError(f"scale (c): the {arm} arm's winners "
                                 "differ from the f32 scan's")
        fused = (arm == "fused" or arm == "auto"
                 and fs.select_serve_form("auto", n_events, "cuda")
                 == "fused")
        check_launches(f"scale (c) {arm}: K2", n_k2, 1 if fused else 0)
    tab = scoring.score_table(torch.from_numpy(theta).cuda(),
                              torch.from_numpy(phi).cuda()).reshape(-1)
    n_real = bundle.n_real_tokens
    flat = (bundle.corpus.doc_ids[:n_real].astype(np.int64) * phi.shape[0]
            + bundle.corpus.word_ids[:n_real])
    si = torch.from_numpy(flat[:n_events].astype(np.int32)).cuda()
    di = torch.from_numpy(flat[n_events:].astype(np.int32)).cuda()
    tab_b = tab.to(torch.bfloat16)
    scr = scoring.table_pair_bottom_k_screened(
        tab, si, di, tab_b, tol=1.0, max_results=SCALE_M)
    if not bool(scr.sound):
        raise AssertionError("scale (c): the bf16 screen did not certify")
    # (e), K2: the kernel alone on the day's two score columns against
    # its plain version, and the times of every arm.
    sa = tab[si.to(torch.int64)].contiguous()
    sb = tab[di.to(torch.int64)].contiguous()
    k2_args = ((sa, sb), None, None, None, None, 1.0)
    k2_kw = dict(mode="min2", max_results=SCALE_M)
    kern = fs.fused_call(*k2_args, **k2_kw)
    plain = fs.fused_call_plain(*k2_args, **k2_kw)
    torch.cuda.synchronize()
    if not (torch.equal(kern.indices, plain.indices)
            and torch.equal(kern.scores, plain.scores)
            and torch.equal(kern.indices, ref.indices)):
        raise AssertionError("scale (e): K2 at the scale day differs from "
                             "its plain version")
    fin = torch.isfinite(plain.scores)
    k2_err = float(torch.where(fin, (kern.scores - plain.scores).abs(),
                               torch.zeros_like(kern.scores)).max())
    screened = torch.minimum(sa, sb)
    screened = torch.where(screened < 1.0, screened,
                           torch.full_like(screened, float("inf")))
    times = {
        "K2 alone": event_ms(lambda: fs.fused_call(*k2_args, **k2_kw),
                             reps=10),
        "K2 plain version": event_ms(
            lambda: fs.fused_call_plain(*k2_args, **k2_kw), reps=10),
        "fused select (gathers + K2)": event_ms(
            lambda: fs.fused_table_pair_bottom_k(
                tab, si, di, tol=1.0, max_results=SCALE_M), reps=10),
        "f32 scan": event_ms(lambda: scoring.table_pair_bottom_k(
            tab, si, di, tol=1.0, max_results=SCALE_M), reps=10),
        "bf16 screened scan": event_ms(
            lambda: scoring.table_pair_bottom_k_screened(
                tab, si, di, tab_b, tol=1.0, max_results=SCALE_M), reps=10),
        "torch.topk of the screened scores": event_ms(
            lambda: torch.topk(screened, SCALE_M, largest=False,
                               sorted=True), reps=10)}
    k2_kw_bound = dict(ops=(sa, sb), mask=None, mode="min2", filt=None,
                       max_results=SCALE_M, shape=(1, n_events))
    bound_ms, bound_by, nbytes, ops = k2_bound(k2_kw_bound, n_events)
    roofline_check(card, f"K2 scale N={n_events}", nbytes,
                   times["K2 alone"])
    form = fs.kernel_form(1, n_events, SCALE_M)
    say(card, f"scale (c): xla, fused, bf16-screened and auto (resolves "
              f"{fs.select_serve_form('auto', n_events, 'cuda')}) "
              f"selections equal bit for bit "
              f"({int((ref.indices >= 0).sum())} winners), screen sound, K2 "
              f"launched once by the fused arm ({form} form) and "
              f"{arms['auto'][1]} time(s) by the auto arm")
    say(card, "scale (e): K2 at N=" + str(n_events) + f", M={SCALE_M}: "
              "equal to plain; " + "; ".join(
                  f"{k} {v:.5f} ms" for k, v in times.items())
              + f" (CUDA events, median of 10); bound {bound_ms:.5f} ms by "
              f"{bound_by} ({nbytes} B, {ops} ops)")
    k2_row = {"N": n_events, "M": SCALE_M, "form": form,
              "launches": arms["fused"][1], "max_abs_err": k2_err,
              "ms": times["K2 alone"], "plain_ms": times["K2 plain version"],
              "bound_ms": bound_ms, "bound_by": bound_by,
              "topk_ms": times["torch.topk of the screened scores"],
              "f32_scan_ms": times["f32 scan"],
              "screened_scan_ms": times["bf16 screened scan"],
              "fused_select_ms": times["fused select (gathers + K2)"]}
    del bundle, tab, tab_b, si, di, sa, sb, screened

    # (d) the streamed host arm: fit on n_train events, score them all.
    saved = os.environ.get("ONIX_HOST_WORDS")
    os.environ["ONIX_HOST_WORDS"] = "1"
    try:
        torch.cuda.synchronize()
        sample_count.launches = 0
        t0 = time.perf_counter()
        with Calls(scale, "_stream_score") as host_arm:
            md = scale.run_scale(n_events, train_events=n_train)
        wall = time.perf_counter() - t0
    finally:
        if saved is None:
            os.environ.pop("ONIX_HOST_WORDS", None)
        else:
            os.environ["ONIX_HOST_WORDS"] = saved
    check_launches("run_scale streamed: K1", sample_count.launches,
                   20 * math.ceil(md["n_train_tokens"] / SCALE_BLOCK))
    if md["words_mode"] != "host":
        raise AssertionError(f"streamed run: words_mode {md['words_mode']}")
    say(card, f"scale (d): run_scale({n_events}, train_events={n_train}) "
              f"under ONIX_HOST_WORDS=1: N={md['n_train_tokens']}, K1 "
              f"launches {sample_count.launches}; walls "
              f"{json.dumps(md['walls_seconds'])}; "
              f"{md['events_per_second_end_to_end']} events/s end to end, "
              f"{md['events_per_second_pipeline_only']} pipeline only; "
              f"planted in the bottom {md['max_results']}: "
              f"{md['planted_in_bottom_k']} of {md['planted_anomalies']}; "
              f"wall {wall:.2f} s")

    # (e), K1: the block step at the scale day's block and table shapes.
    k1_row = step_case(card, "scale day", SCALE_BLOCK, MAIN_K, m["n_vocab"],
                       m["n_docs"], 0, True, seed=61)
    k1_row.update(B=SCALE_BLOCK, launches=launches_b,
                  launches_score_sharded=launches_a)
    return ({"sample_count": k1_row, "fused_serve": k2_row},
            (host_arm.calls[-1][2], md["planted_in_bottom_k"]))


class Calls:
    """Keeps every call of the function `owner.name` while the block
    runs, as (args, kwargs, result) in `calls` and its wall seconds in
    `walls`: what `run_scale` selects (`scale._stream_score`), what the
    stream tail hands K2 (`fused_serve.fused_stream_tail`), or how long
    the demo's `run_oa` took."""

    def __init__(self, owner, name: str):
        self.owner, self.name, self.calls, self.walls = owner, name, [], []

    def __enter__(self):
        self.real = getattr(self.owner, self.name)

        def call(*a, **kw):
            t0 = time.perf_counter()
            out = self.real(*a, **kw)
            self.walls.append(time.perf_counter() - t0)
            self.calls.append((a, kw, out))
            return out
        setattr(self.owner, self.name, call)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.real)
        return False


# -- phase 10 ---------------------------------------------------------------

# The K sweep of both sampler arms on the small day's corpus.
SWEEP_KS = (20, 64, 256, 1024)
# The reference's svi engine on the phase-5 day reaches 0.734 (JAX on a
# CPU host, PERF.md §6), over RECALL_BAR: the svi day is held to it.
SVI_RECALL_BAR = RECALL_BAR


class FitStates:
    """Keeps the state and corpus of every `fit` of the given engine
    classes while the block runs (the CLI returns neither)."""

    def __init__(self, *classes):
        self.classes, self.seen = classes, []

    def __enter__(self):
        self.real = [cls.fit for cls in self.classes]
        for cls, real in zip(self.classes, self.real):
            def fit(model, corpus, *a, _real=real, **kw):
                out = _real(model, corpus, *a, **kw)
                self.seen.append((out, corpus))
                return out
            cls.fit = fit
        return self

    def __exit__(self, *exc):
        for cls, real in zip(self.classes, self.real):
            cls.fit = real
        return False


def check_counts(what: str, state, doc_lengths, n_tokens: int) -> str:
    """The count invariants of a (chained) Gibbs state on the card:
    every chain's n_k sums to N and equals n_wk's column sums, no count
    is negative, and n_dk's row sums are the documents' lengths."""
    import torch
    n_k = state.n_k.reshape(-1, state.n_k.shape[-1])
    n_dk = state.n_dk.reshape(n_k.shape[0], -1, n_k.shape[1])
    n_wk = state.n_wk.reshape(n_k.shape[0], -1, n_k.shape[1])
    rows = torch.as_tensor(doc_lengths, device=n_dk.device)
    ok = ((n_k.sum(dim=1) == n_tokens).all()
          and torch.equal(n_k, n_wk.sum(dim=1, dtype=torch.int32))
          and int(n_dk.min()) >= 0 and int(n_wk.min()) >= 0
          and (n_dk.sum(dim=2) == rows).all())
    if not ok:
        raise AssertionError(f"{what}: a count invariant is broken")
    return (f"n_k sums to {n_tokens} in each of {n_k.shape[0]} chain(s), "
            f"n_dk/n_wk >= 0, n_dk rows = doc lengths")


def score_day(card: str, root: pathlib.Path, table, planted, tag: str,
              args: list[str]):
    """Write the day under `root`, run `onix_torch score` with `args` on
    it, and return (its outputs, recall, K1 launches, wall)."""
    import pandas as pd
    import torch

    from onix_torch import cli
    from onix_torch.models import sample_count
    from onix_torch.store import Store
    Store(root).write("flow", "2016-07-08", table)
    torch.cuda.synchronize()
    sample_count.launches = 0
    t0 = time.perf_counter()
    rc = cli.main(["score", "2016-07-08", "flow", "-s",
                   f"store.root={root}", *args])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = sample_count.launches
    if rc != 0:
        raise AssertionError(f"{tag}: onix_torch score exited {rc}")
    got = day_outputs(root / "results")
    res = pd.read_csv(root / "results" / "20160708" / "flow_results.csv")
    recall = len(set(res["event_idx"]) & set(planted.tolist())) / len(
        planted)
    check_launches(f"{tag}: K1", launches, 0)
    check_launches(f"{tag}: K1 (manifest)",
                   got["manifest"]["kernel_launches"]["sample_count"], 0)
    return got, recall, launches, wall


def stage_walls(got: dict) -> dict:
    return {r["stage"]: r["wall_s"] for r in got["runlog"]
            if r["event"] == "stage_end"}


def phase_sparse_svi(card: str, root: pathlib.Path, table, planted,
                     dense_ll: float) -> dict:
    """(a) the small day (`table`) under `-s lda.sampler_form=sparse` on
    both Gibbs engines: no K1 launch, the count invariants, recall >=
    the bar and the final ll within LL_PARITY_BAND of the small day's
    dense ll (`dense_ll`); (b) two sweeps of each arm on its corpus at K
    in SWEEP_KS,
    timed, with their device launches a block step and the invariants;
    (c) the day under `--engine svi`, twice: byte-identical results and
    clients CSVs, no K1 launch, 2 <= epochs <= lda.svi_max_epochs,
    recall >= SVI_RECALL_BAR. Returns the K1 launches of (a) and (c)."""
    import numpy as np
    import torch

    from onix_torch.config import LDAConfig
    from onix_torch.models import lda_gibbs, sample_count
    from onix_torch.parallel.sharded_gibbs import ShardedGibbsLDA
    from onix_torch.pipelines.corpus_build import build_corpus
    from onix_torch.pipelines.words import flow_words
    launches = {}
    # (a) the sparse day, on both engines.
    for engine in ("gibbs", "sharded"):
        tag = f"sparse day ({engine})"
        with FitStates(lda_gibbs.GibbsLDA, ShardedGibbsLDA) as fits:
            got, recall, k1, wall = score_day(
                card, root / f"sparse_{engine}", table, planted, tag,
                ["-s", "lda.sampler_form=sparse", "--engine", engine])
        (fit, corpus), = fits.seen
        lengths = corpus.doc_lengths()
        if engine == "sharded":
            doc_map = fit["sharded_corpus"].doc_map[0]
            lengths = np.where(doc_map >= 0, lengths[np.maximum(doc_map, 0)],
                               0)
        inv = check_counts(tag, fit["state"], lengths, corpus.n_tokens)
        man = got["manifest"]
        lls = [ll for _, ll in man["ll_history"]]
        gap = abs(lls[-1] - dense_ll) / abs(dense_ll)
        launches[f"launches_sparse_day_{engine}"] = k1
        say(card, f"{tag}: onix_torch score 2016-07-08 flow -s "
                  f"lda.sampler_form=sparse --engine {engine}: D="
                  f"{man['n_docs']} V={man['n_vocab']} N={man['n_tokens']}, "
                  f"K1 launches {k1}; {inv}; wall {wall:.2f} s; stages "
                  f"{json.dumps(stage_walls(got))}; recall {recall:.4f} "
                  f"(bar {RECALL_BAR}); ll {lls[0]:.5f} -> {lls[-1]:.5f}, "
                  f"{gap:.4f} relative from the dense {dense_ll:.5f} "
                  f"(band {lda_gibbs.LL_PARITY_BAND})")
        if recall < RECALL_BAR or gap > lda_gibbs.LL_PARITY_BAND:
            raise AssertionError(f"{tag}: recall {recall}, ll gap {gap}")

    # (b) the K sweep.
    corpus = build_corpus(flow_words(table)).corpus
    for k in SWEEP_KS:
        for form in ("dense", "sparse"):
            tag = f"K sweep K={k} {form}"
            model = lda_gibbs.GibbsLDA(
                LDAConfig(n_topics=k, sampler_form=form), corpus.n_docs,
                corpus.n_vocab, device="cuda")
            docs, words, mask = model.prepare(corpus)
            cfg = model.config
            noise = lda_gibbs.TorchNoise(cfg.seed, "cuda")
            st = lda_gibbs.init_state(docs, words, mask, corpus.n_docs,
                                      corpus.n_vocab, k, noise)

            def one_sweep():
                lda_gibbs.sweep(st, docs, words, mask, alpha=cfg.alpha,
                                eta=cfg.eta, n_vocab=corpus.n_vocab,
                                accumulate=False, noise=noise,
                                use_gumbel=True, **model.sampler_kw)
            torch.cuda.synchronize()
            sample_count.launches = 0
            ms = []
            for _ in range(2):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                one_sweep()
                b.record()
                b.synchronize()
                ms.append(a.elapsed_time(b))
            k1 = sample_count.launches
            nb = docs.shape[0]
            check_launches(f"{tag}: K1", k1, 2 * nb if form == "dense"
                           else 0)
            ops = most_launches(one_sweep)
            per = sum(c for _, c, _ in ops) / nb
            busy = sum(t for _, _, t in ops)
            inv = check_counts(tag, st, corpus.doc_lengths(),
                               corpus.n_tokens)
            width = model.sparse_active if form == "sparse" else "-"
            say(card, f"{tag}: A={width}, {nb} blocks of {docs.shape[1]}: "
                      f"{ms[0]:.2f} / {ms[1]:.2f} ms a sweep (CUDA events), "
                      f"{per:.2f} device launches a block step, device busy "
                      f"{busy:.2f} ms a sweep (profiled), K1 launches {k1}; "
                      f"{inv}")
            del st, noise

    # (c) the svi day, twice.
    outs = []
    for run in ("a", "b"):
        tag = f"svi day (run {run})"
        got, recall, k1, wall = score_day(card, root / f"svi_{run}", table,
                                          planted, tag, ["--engine", "svi"])
        man = got["manifest"]
        lls = [ll for _, ll in man["ll_history"]]
        iters = man["svi"]["estep_iters"]
        max_epochs = LDAConfig().svi_max_epochs
        say(card, f"{tag}: onix_torch score 2016-07-08 flow --engine svi: "
                  f"D={man['n_docs']} N={man['n_tokens']}, K1 launches "
                  f"{k1}, {len(lls)} epochs, E-step iterations a batch "
                  f"{iters}; wall {wall:.2f} s; stages "
                  f"{json.dumps(stage_walls(got))}; recall {recall:.4f} "
                  f"(bar {SVI_RECALL_BAR}); ll {lls[0]:.5f} -> {lls[-1]:.5f}")
        if not 2 <= len(lls) <= max_epochs or recall < SVI_RECALL_BAR:
            raise AssertionError(f"{tag}: {len(lls)} epochs, recall "
                                 f"{recall}")
        launches[f"launches_svi_day_{run}"] = k1
        outs.append(got)
    for name in ("results", "clients"):
        if outs[0][name] != outs[1][name]:
            raise AssertionError(f"svi day: the two runs' {name} CSVs "
                                 "differ")
    say(card, "svi day: the two runs' results and clients CSVs are "
              "byte-identical")
    return launches


# -- phase 11 ---------------------------------------------------------------

# (a) and (b): the reference's streaming protocol (bench.py
# bench_streaming): 10 batches of 100,000 flow events a feed, a warm feed
# from seed 500 and a timed one from seed 900, 2^12 buckets, the default
# config; one arm per batch, one at supersteps of 5.
STREAM_BATCHES, STREAM_EVENTS, STREAM_HOSTS, STREAM_PLANTS = 10, 100_000, \
    400, 8
STREAM_BUCKETS, STREAM_SUPERSTEP = 1 << 12, 5
STREAM_ULPS = 8 * 2.0 ** -23       # the serving tests' score bound
# (c): the small day as 4 NetFlow v5 files through `stream --epochs 2`
# at the default 2^15 buckets. The bar is the reference's share of the
# planted events alerted in their own file in the last epoch on the
# phase-5 day as 4 files: its `run_stream` at the default config (JAX
# 0.9.0 on an 8-core x86 CPU host) gave 996 of 1,000; `ONIX_JUDGED=1
# JAX_PLATFORMS=cpu python -m pytest tests/test_torch_streaming.py -k
# reference_stream_share -s` reruns it.
STREAM_FILES = 4
STREAM_REF_SHARE = 0.996
STREAM_SHARE_SLACK = 0.05
# (e): a streamed scale day (fitted on a prefix, scored in chunks) finds
# fewer of its planted anomalies than a day fitted on all its events
# (phase 9 (b)'s bar, 0.8): the reference's own streamed 10^7-event flow
# run with device words found 737 of 1,000 (docs/SCALE_1E7_r06_flow.json:
# JAX on a CPU host, fitted on the first 10^6 events). The device words
# arm is held to the host words arm's count, and to that share less
# the slack.
SCALE_STREAMED_REF_SHARE = 0.737


def stream_feed(seed0: int) -> list:
    from onix_torch.pipelines.synth import synth_flow_day
    return [synth_flow_day(STREAM_EVENTS, n_hosts=STREAM_HOSTS,
                           n_anomalies=STREAM_PLANTS, seed=seed0 + b)[0]
            for b in range(STREAM_BATCHES)]


def stream_arm(card: str, warm, timed, superstep: int, form: str):
    """A scorer at the default config warmed on `warm`, then timed on
    `timed`: (scorer, results, wall seconds, dispatch deltas, K2
    launches of the timed feed)."""
    import torch

    from onix_torch.config import OnixConfig
    from onix_torch.models import fused_serve as fs
    from onix_torch.pipelines.streaming import StreamingScorer
    cfg = OnixConfig()
    cfg.pipeline.stream_superstep = superstep
    cfg.serving.serve_form = form
    sc = StreamingScorer(cfg.validate(), "flow", n_buckets=STREAM_BUCKETS)
    sc.process_many([(t, None) for t in warm])
    for key in sc.stage_walls:
        sc.stage_walls[key] = 0.0
    base = dict(sc.dispatches)
    words0 = dict(sc.words_mode_batches)
    iters0 = len(sc.estep_stats["iters"])
    torch.cuda.synchronize()
    fs.launches = 0
    t0 = time.perf_counter()
    results = sc.process_many([(t, None) for t in timed])
    wall = time.perf_counter() - t0
    k2 = fs.launches
    disp = {k: v - base[k] for k, v in sc.dispatches.items()}
    words = {k: v - words0[k] for k, v in sc.words_mode_batches.items()}
    if words != {"device": len(timed), "host": 0}:
        raise AssertionError(f"stream (S={superstep}, {form}): words arm "
                             f"{words} on the timed feed, want device on "
                             "every batch")
    n = sum(r.n_events for r in results)
    say(card, f"stream (a) S={superstep} tail={form}: {n / wall:.1f} "
              f"events/s over {len(timed)} batches of {STREAM_EVENTS} "
              f"({wall:.3f} s); stage walls "
              f"{json.dumps({k: round(v, 4) for k, v in sc.stage_walls.items()})}"
              f"; dispatches {json.dumps(disp)}; E-step iterations a batch "
              f"{sc.estep_stats['iters'][iters0:]}; pad shapes "
              f"{sorted(sc.pad_shapes)}, superstep shapes "
              f"{sorted(sc.superstep_shapes)}; alerts a batch "
              f"{[len(r.alerts) for r in results]}; K2 launches {k2}")
    return sc, results, wall, disp, k2


def pairs_of(alerts):
    from onix_torch.feedback.filter import pack_pair
    from onix_torch.pipelines.words import str_to_ip
    return set(pack_pair(str_to_ip(alerts["sip"]),
                         str_to_ip(alerts["dip"])).tolist())


def tail_timing(card: str, label: str, call, n_events: int) -> dict:
    """K2 at the stream tail's shape, from one recorded
    `fused_stream_tail` call: the kernel against its plain version on
    the same tensors (exact), their times, torch.topk of the screened
    event scores, and the byte bound."""
    import torch

    from onix_torch.models import fused_serve as fs
    (src, dst, w_src, w_dst, ph, pl, filt), kw = call[0][:7], call[1]
    args = ((src, dst), None,
            None if filt is None else (w_src, w_dst),
            None if filt is None else (ph, pl), filt, kw["tol"])
    k2_kw = dict(mode="min2", max_results=kw["max_results"],
                 token_words=True, return_scores=True)
    kern_top, kern_ev = fs.fused_call(*args, **k2_kw)
    plain_top, plain_ev = fs.fused_call_plain(*args, **k2_kw)
    torch.cuda.synchronize()
    if not (torch.equal(kern_top.indices, plain_top.indices)
            and torch.equal(kern_top.scores, plain_top.scores)
            and torch.equal(kern_ev, plain_ev)):
        raise AssertionError(f"stream tail ({label}): K2 differs from its "
                             "plain version")
    fin = torch.isfinite(plain_top.scores)
    err = float(torch.where(fin, (kern_top.scores - plain_top.scores).abs(),
                            torch.zeros_like(plain_top.scores)).max())
    tol = torch.tensor(kw["tol"], dtype=torch.float32, device=src.device)
    screened = torch.where(plain_ev < tol, plain_ev,
                           torch.full_like(plain_ev, float("inf")))
    m = kw["max_results"]
    times = {"ms": event_ms(lambda: fs.fused_call(*args, **k2_kw)),
             "plain_ms": event_ms(lambda: fs.fused_call_plain(*args,
                                                             **k2_kw)),
             "topk_ms": event_ms(lambda: torch.topk(screened, m,
                                                    largest=False,
                                                    sorted=True))}
    bound_ms, bound_by, nbytes, ops = k2_bound(
        dict(ops=(src, dst), mask=None, mode="min2", filt=filt,
             token_words=True, return_scores=True, max_results=m,
             shape=(1, n_events)), n_events)
    roofline_check(card, f"K2 stream tail ({label})", nbytes, times["ms"])
    say(card, f"stream tail K2 ({label}): N={n_events}, M={m}, "
              f"{fs.kernel_form(1, n_events, m)} form, equal to plain; "
              f"K2 {times['ms']:.5f} ms, plain {times['plain_ms']:.5f} ms, "
              f"torch.topk of the screened scores {times['topk_ms']:.5f} ms "
              f"(CUDA events, median of 30); bound {bound_ms:.5f} ms by "
              f"{bound_by} ({nbytes} B, {ops} ops)")
    return {"N": n_events, "M": m, "filtered": filt is not None,
            "form": fs.kernel_form(1, n_events, m), "max_abs_err": err,
            **times, "bound_ms": bound_ms, "bound_by": bound_by}


def write_day_files(table, out: pathlib.Path) -> list:
    """The day as STREAM_FILES NetFlow v5 files, in event order. The
    exporter's uptime spans two days, so every flow's offset from it
    is positive and the decoded times are the day's."""
    import numpy as np

    from onix_torch.ingest.nfdecode import write_v5
    out.mkdir(parents=True, exist_ok=True)
    epoch = (np.asarray(table["treceived"], dtype="datetime64[s]")
             .astype(np.int64).astype(np.float64))
    table = table.assign(start_ts=epoch, end_ts=epoch + 10.0)
    per = len(table) // STREAM_FILES
    paths = []
    for f in range(STREAM_FILES):
        p = out / f"day_{f}.nf5"
        p.write_bytes(write_v5(table.iloc[f * per:(f + 1) * per]
                               .reset_index(drop=True),
                               sys_uptime_ms=172_800_000))
        paths.append(str(p))
    return paths


def stream_share(log: str, results: pathlib.Path, planted,
                 n_events: int) -> float:
    """The share of the planted events that a two-epoch `stream flow`
    run over the day's STREAM_FILES files alerted in their own file in
    the last epoch, from its output (`log`: the alerts of each file, in
    file order) and its alert CSV under `results` (appended in that
    order, each file's `event_idx` local to it)."""
    import pandas as pd
    counts = [int(c) for c in re.findall(
        r"^\[epoch 1\] .*?: \d+ events, (\d+) alerts", log, re.M)]
    csv = pd.read_csv(results / "20160708" / "flow_streaming.csv")
    if len(counts) != STREAM_FILES or sum(counts) != len(csv) or not len(csv):
        raise AssertionError(f"stream: {counts} alerts a file against "
                             f"{len(csv)} CSV rows")
    hits, off = set(), 0
    per_file = n_events // STREAM_FILES
    for f, c in enumerate(counts):
        block = csv["event_idx"].to_numpy()[off:off + c]
        hits |= set((block + f * per_file).tolist())
        off += c
    return len(hits & set(planted.tolist())) / len(planted)


def band_events(md: dict, n_events: int, n_train: int):
    """The streamed chunks' events whose device word differs from the
    host word (the f32-vs-f64 bin-edge band of device_words.py), with
    the largest distance, in f32 ulps, of such an event's binned value
    from its nearest edge. Returns (global event ids, max ulps)."""
    import numpy as np
    import torch

    from onix_torch.pipelines import device_words as dw
    from onix_torch.pipelines import scale
    from onix_torch.pipelines.corpus_build import build_corpus
    from onix_torch.pipelines.synth import SYNTH_ARRAYS
    n_hosts = md["n_hosts"]
    cols = SYNTH_ARRAYS["flow"](n_train, n_hosts=n_hosts,
                                n_anomalies=scale._default_anomalies(n_train),
                                seed=md["seed"])
    wt = scale._words_from_cols("flow", cols)
    bundle = build_corpus(wt)
    edges = wt.edges
    v_x, d_x = bundle.corpus.n_vocab + 1, bundle.corpus.n_docs + 1
    n_chunks = -(-n_events // n_train)
    per_chunk = max(1, scale._default_anomalies(n_events) // n_chunks)
    band, worst = [], 0.0
    # (column, edge name, log1p-binned)
    feats = (("hour", "hour", False), ("ibyt", "log_ibyt", True),
             ("ipkt", "log_ipkt", True))
    for c in range(1, n_chunks):
        m = min(n_train, n_events - c * n_train)
        cc = SYNTH_ARRAYS["flow"](m, n_hosts=n_hosts, n_anomalies=per_chunk,
                                  seed=md["seed"] + 1000 * c)
        wt2 = scale._words_from_cols("flow", cc, edges=edges)
        host = (bundle.doc_ids_u32(wt2.ip_u32, fill=d_x - 1) * np.int64(v_x)
                + bundle.word_ids_packed(wt2.word_key, fill=v_x - 1))
        tables = dw.build_flow_tables(bundle, edges,
                                      list(cc["proto_classes"]), "cuda")
        st = dw.stage_flow_cols(cc, "cuda")
        ds, dd = dw._flow_flat_idx(
            tables, v_x, v_x - 1, d_x - 1, st["sip_u32"], st["dip_u32"],
            st["sport"], st["dport"], st["proto_id"], st["hour"],
            st["ibyt"], st["ipkt"])
        dev = torch.cat([ds, dd]).cpu().numpy()
        off = np.flatnonzero((dev != host)[:m] | (dev != host)[m:])
        band.extend((off + c * n_train).tolist())
        if len(off):
            ulps = np.full(len(off), np.inf)
            for col, name, log in feats:
                x = np.asarray(cc[col], np.float32)[off]
                x = np.log1p(x) if log else x
                e = np.asarray(edges[name], np.float32)
                gap = np.abs(x[:, None] - e[None, :]).min(axis=1)
                ulps = np.minimum(ulps, gap / np.spacing(np.abs(x)))
            worst = max(worst, float(ulps.max()))
        del cc, wt2, host, dev, st
    return set(band), worst


def phase_stream(card: str, root: pathlib.Path, table, planted,
                 host_arm) -> dict:
    """The streaming path on the card: see the module docstring.
    `host_arm` is phase 9 (d)'s (winners, planted among them). Returns
    the stream-tail entry of K2's row in the kernels line."""
    import contextlib
    import io
    import os

    import numpy as np
    import pandas as pd
    import torch

    from onix_torch import cli
    from onix_torch.models import fused_serve as fs
    from onix_torch.models import sample_count
    from onix_torch.pipelines import scale
    from onix_torch.store import Store
    torch.cuda.synchronize()
    sample_count.launches = fs.launches = 0
    # (a) the protocol's two arms.
    warm, timed = stream_feed(500), stream_feed(900)
    per, res_1, wall_1, _, k2_1 = stream_arm(card, warm, timed, 1, "xla")
    _, res_s, wall_s, disp_s, k2_s = stream_arm(card, warm, timed,
                                                STREAM_SUPERSTEP, "xla")
    for b, (x, y) in enumerate(zip(res_1, res_s)):
        if set(x.alerts["event_idx"]) != set(y.alerts["event_idx"]):
            raise AssertionError(f"stream (a): batch {b}'s winner sets "
                                 "differ between the arms")
    if disp_s["superstep"] != STREAM_BATCHES // STREAM_SUPERSTEP or \
            disp_s["svi_update"] or disp_s["score"]:
        raise AssertionError(f"stream (a): superstep dispatches {disp_s}")
    check_launches("stream (a): K1", sample_count.launches, 0)
    check_launches("stream (a): K2", k2_1 + k2_s, 0)
    say(card, f"stream (a): winner sets identical per batch; superstep "
              f"{wall_1 / wall_s:.3f}x the per-batch arm's rate; K1 "
              "launches 0, K2 launches 0")

    # (b) the fused tail: K2 once a batch, the host tail's answers.
    with Calls(fs, "fused_stream_tail") as tails:
        fused, res_f, _, _, n_k2 = stream_arm(card, warm, timed, 1, "fused")
        check_launches("stream (b): K2", n_k2, STREAM_BATCHES)
        for b, (x, y) in enumerate(zip(res_1, res_f)):
            xi, yi = (r.alerts["event_idx"].to_numpy() for r in (x, y))
            rel = np.abs(y.scores - x.scores) / np.abs(x.scores)
            if not np.array_equal(xi, yi) or rel.max() > STREAM_ULPS:
                raise AssertionError(f"stream (b): batch {b}: the fused "
                                     "tail's winners or scores differ from "
                                     "the host tail's")
        plain_call = tails.calls[-1]
        # Feedback: 3 benign labels from batch 9's alerts, immediate,
        # then batch 9 once more through both tails.
        rows = res_f[-1].alerts.head(3).drop(columns=["score", "event_idx"])
        dismissed = pairs_of(rows)
        for sc in (per, fused):
            sc.apply_feedback(rows, [3, 3, 3], immediate=True, online=False)
        fs.launches = 0
        again_x = per.process(timed[-1])
        again_f = fused.process(timed[-1])
        check_launches("stream (b) filtered: K2", fs.launches, 1)
        n_k2 += 1
    filt_call = tails.calls[-1]
    if filt_call[0][6] is None or fused.noise_filter is None:
        raise AssertionError("stream (b): the filtered batch did not run "
                             "K2's token_words mode")
    if not (np.array_equal(again_x.scores, again_f.scores)
            and again_x.alerts["event_idx"].tolist()
            == again_f.alerts["event_idx"].tolist()):
        raise AssertionError("stream (b): the two tails disagree under the "
                             "filter")
    if not dismissed <= pairs_of(res_f[-1].alerts) or \
            dismissed & pairs_of(again_f.alerts):
        raise AssertionError("stream (b): the dismissed pairs did not leave "
                             "the winners")
    say(card, f"stream (b): tail=fused: {n_k2 - 1} K2 launches for "
              f"{STREAM_BATCHES} batches, winners and order equal to the "
              f"host tail's, scores within {STREAM_ULPS:.3g} relative; "
              f"3 benign labels installed ({fused.feedback_stats}); batch "
              f"9 again: token_words mode, both tails equal, "
              f"{len(dismissed)} dismissed pairs gone from "
              f"{len(again_f.alerts)} winners")
    tail_rows = [tail_timing(card, "no filter", plain_call, STREAM_EVENTS),
                 tail_timing(card, "filtered", filt_call, STREAM_EVENTS)]
    del warm, timed, res_1, res_s, res_f, per, fused

    # (c) the CLI over raw files, two epochs.
    files = write_day_files(table, root / "stream_files")
    store = root / "stream_store"
    torch.cuda.synchronize()
    sample_count.launches = fs.launches = 0
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), \
            Calls(fs, "fused_stream_tail") as auto_tails:
        rc = cli.main(["stream", "flow", *files, "--epochs", "2", "-s",
                       f"store.root={store}", "-s",
                       f"store.results_dir={store / 'results'}"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    log = out.getvalue()
    print(log, end="", flush=True)
    if rc != 0:
        raise AssertionError(f"onix_torch stream exited {rc}")
    check_launches("stream (c): K1", sample_count.launches, 0)
    # "auto": the gate at one file's events decides the tail; a K2 launch
    # for each batch that took the device layout, none for the host tail.
    tail_form = fs.select_serve_form("auto", len(table) // STREAM_FILES,
                                     "cuda")
    check_launches(f"stream (c): K2 (auto resolves {tail_form})",
                   fs.launches, len(auto_tails.calls))
    if (len(auto_tails.calls) > 0) != (tail_form == "fused"):
        raise AssertionError(f"stream (c): {len(auto_tails.calls)} fused "
                             f"tails under a gate that says {tail_form}")
    share = stream_share(log, store / "results", planted, len(table))
    mode = re.search(r"stream prefetch: mode=(\w+)", log)
    say(card, f"stream (c): onix_torch stream flow <{STREAM_FILES} v5 "
              f"files> --epochs 2: {2 * len(table) / wall:.1f} events/s "
              f"({wall:.2f} s, both epochs), prefetch mode "
              f"{mode.group(1) if mode else 'none'}, K1 launches 0, K2 "
              f"launches {fs.launches} (auto resolves {tail_form}); "
              f"planted events alerted in their own file in epoch 2: "
              f"{share:.4f} (bar {STREAM_REF_SHARE} - {STREAM_SHARE_SLACK})")
    if share < STREAM_REF_SHARE - STREAM_SHARE_SLACK:
        raise AssertionError(f"stream (c): share {share}")

    # (d) ingest the same files, then score the day.
    istore = root / "ingest_store"
    rc = cli.main(["ingest", "flow", *files, "-s", f"store.root={istore}"])
    n_rows = len(Store(istore).read("flow", "2016-07-08"))
    if rc != 0 or n_rows != len(table):
        raise AssertionError(f"stream (d): ingest exited {rc} with {n_rows} "
                             "rows")
    torch.cuda.synchronize()
    sample_count.launches = 0
    t0 = time.perf_counter()
    rc = cli.main(["score", "2016-07-08", "flow", "-s",
                   f"store.root={istore}"])
    wall = time.perf_counter() - t0
    got = day_outputs(istore / "results")
    man = got["manifest"]
    check_launches("stream (d): K1", sample_count.launches,
                   60 * math.ceil(man["n_tokens"] / 65_536))
    res = pd.read_csv(istore / "results" / "20160708" / "flow_results.csv")
    recall = len(set(res["event_idx"]) & set(planted.tolist())) / len(
        planted)
    say(card, f"stream (d): ingest flow <{STREAM_FILES} files>: {n_rows} "
              f"rows; score 2016-07-08 flow: K1 launches "
              f"{sample_count.launches}, wall {wall:.2f} s, stages "
              f"{json.dumps(stage_walls(got))}, recall {recall:.4f} (bar "
              f"{RECALL_BAR})")
    if rc != 0 or recall < RECALL_BAR:
        raise AssertionError(f"stream (d): score exited {rc}, recall "
                             f"{recall}")

    # (e) the scale run's device words arm against phase 9 (d)'s host arm.
    saved = {k: os.environ.pop(k, None) for k in ("ONIX_HOST_WORDS",
                                                  "ONIX_DEVICE_WORDS")}
    try:
        sample_count.launches = 0
        t0 = time.perf_counter()
        with Calls(scale, "_stream_score") as dev_arm:
            me = scale.run_scale(SCALE_EVENTS, train_events=SCALE_TRAIN)
        wall = time.perf_counter() - t0
    finally:
        for k, v in saved.items():
            if v is not None:
                os.environ[k] = v
    if me["words_mode"] != "device":
        raise AssertionError(f"stream (e): words_mode {me['words_mode']}")
    band, worst = band_events(me, SCALE_EVENTS, SCALE_TRAIN)
    (hi, hs), host_hits = host_arm
    di, ds = dev_arm.calls[-1][2]
    keep_h = np.array([i not in band for i in hi.tolist()], bool)
    keep_d = np.array([i not in band for i in di.tolist()], bool)
    n = min(keep_h.sum(), keep_d.sum())
    if not (np.array_equal(hi[keep_h][:n], di[keep_d][:n])
            and np.array_equal(hs[keep_h][:n], ds[keep_d][:n])):
        raise AssertionError("stream (e): the device words arm's winners "
                             "differ from the host arm's outside the band")
    hits, n_planted = me["planted_in_bottom_k"], me["planted_anomalies"]
    say(card, f"stream (e): run_scale({SCALE_EVENTS}, train_events="
              f"{SCALE_TRAIN}) with device words: words_mode "
              f"{me['words_mode']}, K1 launches {sample_count.launches}; "
              f"walls {json.dumps(me['walls_seconds'])}; "
              f"{me['events_per_second_end_to_end']} events/s end to end, "
              f"{me['events_per_second_pipeline_only']} pipeline only; wall "
              f"{wall:.2f} s; f32 edge band: {len(band)} events of the "
              f"streamed chunks (largest distance from an edge "
              f"{worst:.1f} ulps), {int((~keep_h).sum())} of the host "
              f"arm's and {int((~keep_d).sum())} of the device arm's "
              f"winners in it; the other winners equal in order and "
              f"score; planted in the bottom {me['max_results']}: {hits} "
              f"of {n_planted}, the host arm {host_hits} (bar: the host "
              f"arm's, and {SCALE_STREAMED_REF_SHARE} - "
              f"{STREAM_SHARE_SLACK} of them)")
    if hits != host_hits or hits < (SCALE_STREAMED_REF_SHARE
                                    - STREAM_SHARE_SLACK) * n_planted:
        raise AssertionError(f"stream (e): {hits} of {n_planted} planted, "
                             f"the host arm {host_hits}")
    return {"launches": n_k2, **tail_rows[0], "filtered_tail": tail_rows[1]}


# -- phase 12 (a)-(e) ---------------------------------------------------------

# (b) the session generator at the reference test's shape
# (tests/test_synth2.py), then flow at docs/RECALL_r05_sessions_small.json's.
SESSIONS_EVENTS, SESSIONS_HOSTS, SESSIONS_SWEEPS, SESSIONS_M = (
    60_000, 500, 16, 2000)
SESSIONS_BAR = 0.3
RECALL_SMALL = dict(n_events=2_000_000, n_hosts=20_000, n_anomalies=60,
                    n_sweeps=40, seed=0)
RECALL_SMALL_DEPTHS = (1000, 3000, 10000)
# docs/RECALL_r05_sessions_small.json, arms.after_tail_bins.flow.recall
# (JAX GibbsLDA, block 2^14, on a CPU host): the share of the planted
# events in the top 1,000 / 3,000 / 10,000.
RECALL_SMALL_REF = {1000: 0.3833, 3000: 0.4, 10000: 0.5167}
# (d) the reference's serving bench shape (bench.py bench_model_bank, not
# `small`), uncached; the residency identity at capacity 8.
BENCH_SPEC = dict(n_tenants=32, n_docs=2048, n_vocab=1024, n_topics=20,
                  n_requests=96, events_per_request=4096, n_windows=0,
                  batch_requests=48, tol=1.0, max_results=100, seed=7)
BENCH_CAPACITY = 8
OVERLOAD_RUNS = 3


def no_fallback(what: str) -> None:
    """No wave fell back from K2 to the xla form: on the card the ladder
    has no rung, so `serve.form_fallback` stays 0, the drill included."""
    from onix_torch.utils.obs import counters
    if counters.get("serve.form_fallback"):
        raise AssertionError(f"{what}: serve.form_fallback = "
                             f"{counters.get('serve.form_fallback')}")


def row_hashes(df):
    """The multiset of a frame's rows as sorted hashes (row order in a
    store depends on which worker appended first)."""
    import numpy as np
    import pandas as pd
    return np.sort(pd.util.hash_pandas_object(df, index=False).to_numpy())


def phase_watch(card: str, root: pathlib.Path) -> None:
    """(a) `watch --drain` over phase 11's four v5 files and one capture
    cut inside its first packet header, with --procs 1 and --procs 2
    into fresh stores, as a user runs it (`python -m onix_torch.cli`).
    The reference's rules: one process carries the torn file through
    the retry budget to quarantine (exit 1: its failed attempts count as
    errors); worker processes give it one attempt a drain and leave it
    (exit 1). Both stores hold phase 11 (d)'s ingested rows; a second
    drain ingests nothing. The two stores are independent, so the
    --procs 1 and --procs 2 drains run side by side."""
    import hashlib
    import os
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    from onix_torch.store import Store
    from onix_torch.utils.resilience import RetryPolicy
    files = sorted((root / "stream_files").glob("day_*.nf5"))
    want = Store(root / "ingest_store").read("flow", "2016-07-08")
    attempts = RetryPolicy().max_attempts
    with bounded("config", "python -m onix_torch.cli config") as lim:
        cfg = subprocess.run(
            [sys.executable, "-m", "onix_torch.cli", "config", "-s",
             f"store.root={root / 'watch'}"], cwd=HERE, capture_output=True,
            text=True, check=True, timeout=lim).stdout
    say(card, f"watch (a): `config` printed {len(cfg)} bytes, sha256 "
              f"{hashlib.sha256(cfg.encode()).hexdigest()[:16]}")

    def drains(procs: int) -> None:
        landing = root / f"watch_landing_{procs}"
        landing.mkdir()
        for f in files:
            shutil.copy(f, landing / f.name)
        (landing / "torn.nf5").write_bytes(files[0].read_bytes()[:20])
        old = time.time() - 60
        for f in landing.iterdir():
            os.utime(f, (old, old))
        store = root / f"watch_store_{procs}"
        cmd = [sys.executable, "-m", "onix_torch.cli", "watch", "flow",
               str(landing), "--procs", str(procs), "--drain",
               "--max-seconds", "600", "-s", f"store.root={store}"]
        for run in (1, 2):
            t0 = time.perf_counter()
            with bounded("watch drain", f"watch --procs {procs} drain "
                                        f"{run}") as lim:
                out = subprocess.run(cmd, cwd=HERE, capture_output=True,
                                     text=True, timeout=lim)
            wall = time.perf_counter() - t0
            last = out.stdout.strip().splitlines()[-1] if out.stdout \
                else out.stderr[-500:]
            say(card, f"watch (a): --procs {procs} drain {run}: exit "
                      f"{out.returncode}, {wall:.2f} s: {last}")
            torn_quarantined = (landing / "quarantine" / "torn.nf5").exists()
            if procs == 1:
                want_line = (
                    f"onix watch: {len(files)} files, {len(want)} rows, "
                    f"{attempts} errors, {attempts - 1} retries, 1 "
                    "quarantined, 0 salvaged" if run == 1 else
                    "onix watch: 0 files, 0 rows, 0 errors, 0 retries, 0 "
                    "quarantined, 0 salvaged")
                want_rc, want_q = (1 if run == 1 else 0), True
            else:
                want_line = (f"onix watch: {len(files) if run == 1 else 0} "
                             f"files, {len(want) if run == 1 else 0} rows, "
                             "1 errors, 1 retries, 0 quarantined, 0 "
                             "salvaged (2 workers)")
                want_rc, want_q = 1, False
            if (out.returncode, last, torn_quarantined) != \
                    (want_rc, want_line, want_q):
                raise AssertionError(
                    f"watch --procs {procs} drain {run}: exit "
                    f"{out.returncode}, {last!r}, torn quarantined "
                    f"{torn_quarantined}; want {want_rc}, {want_line!r}, "
                    f"{want_q}")
        got = Store(store).read("flow", "2016-07-08")
        if len(got) != len(want) or not (row_hashes(got)
                                         == row_hashes(want)).all():
            raise AssertionError(f"watch --procs {procs}: the store's "
                                 f"{len(got)} rows are not phase 11 (d)'s "
                                 f"{len(want)}")

    # Each drain's own timeout ends its thread; the join is bounded too.
    with ThreadPoolExecutor(max_workers=2) as pool:
        futs = {procs: pool.submit(drains, procs) for procs in (1, 2)}
        for procs, fut in futs.items():
            with bounded("watch drains join",
                         f"the --procs {procs} drains") as lim:
                fut.result(timeout=lim)
    say(card, f"watch (a): both stores hold {len(want)} rows equal to "
              f"`ingest`'s; the torn capture quarantined after {attempts} "
              "attempts in one process, retried once a drain by the "
              "workers")
    no_fallback("watch (a)")


def sessions_recall(order, planted, depths) -> dict:
    hits = set(int(i) for i in planted)
    return {d: len(hits & set(order[:d].tolist())) / len(hits)
            for d in depths}


def phase_sessions(card: str) -> int:
    """(b) `run_scale(generator="sessions")` for flow, dns and proxy at
    the reference test's shape on K1 (bar: 0.3 of the planted), with
    K1 launches of sweeps x blocks; then flow at the small recall
    record's shape, its recall printed beside the record's (no bar).
    Returns K1's launches."""
    import numpy as np
    import torch

    from onix_torch.models import fused_serve as fs
    from onix_torch.models import sample_count
    from onix_torch.pipelines import scale
    total = 0
    for datatype in ("flow", "dns", "proxy"):
        torch.cuda.synchronize()
        sample_count.launches = 0
        t0 = time.perf_counter()
        m = scale.run_scale(SESSIONS_EVENTS, n_hosts=SESSIONS_HOSTS,
                            n_sweeps=SESSIONS_SWEEPS, datatype=datatype,
                            generator="sessions", max_results=SESSIONS_M)
        wall = time.perf_counter() - t0
        want = SESSIONS_SWEEPS * math.ceil(m["n_train_tokens"] / SCALE_BLOCK)
        check_launches(f"sessions (b) {datatype}: K1", sample_count.launches,
                       want)
        total += sample_count.launches
        hits, n = m["planted_in_bottom_k"], m["planted_anomalies"]
        say(card, f"sessions (b): {datatype} {SESSIONS_EVENTS} events, "
                  f"D={m['n_docs']} V={m['n_vocab']} N={m['n_train_tokens']}"
                  f", K1 launches {sample_count.launches}; {hits} of {n} "
                  f"planted in the bottom {SESSIONS_M} (bar {SESSIONS_BAR}); "
                  f"{wall:.2f} s")
        if hits < SESSIONS_BAR * n:
            raise AssertionError(f"sessions (b) {datatype}: {hits} of {n}")
    torch.cuda.synchronize()
    sample_count.launches = fs.launches = 0
    t0 = time.perf_counter()
    with Calls(scale, "select_suspicious_events") as sel:
        m = scale.run_scale(RECALL_SMALL["n_events"], datatype="flow",
                            generator="sessions",
                            n_hosts=RECALL_SMALL["n_hosts"],
                            n_anomalies=RECALL_SMALL["n_anomalies"],
                            n_sweeps=RECALL_SMALL["n_sweeps"],
                            seed=RECALL_SMALL["seed"],
                            max_results=max(RECALL_SMALL_DEPTHS))
    wall = time.perf_counter() - t0
    want = RECALL_SMALL["n_sweeps"] * math.ceil(m["n_train_tokens"]
                                                / SCALE_BLOCK)
    check_launches("sessions (b) small record: K1", sample_count.launches,
                   want)
    total += sample_count.launches
    from onix_torch.pipelines.synth2 import SYNTH2_ARRAYS
    planted = SYNTH2_ARRAYS["flow"](
        RECALL_SMALL["n_events"], n_hosts=RECALL_SMALL["n_hosts"],
        n_anomalies=RECALL_SMALL["n_anomalies"],
        seed=RECALL_SMALL["seed"])["anomaly_idx"]
    order = sel.calls[-1][2].indices.cpu().numpy()
    order = order[order >= 0]
    rec = sessions_recall(order, planted, RECALL_SMALL_DEPTHS)
    if m["planted_in_bottom_k"] != round(rec[max(RECALL_SMALL_DEPTHS)]
                                         * len(planted)):
        raise AssertionError("sessions (b): the captured winners are not "
                             "the manifest's")
    say(card, f"sessions (b): flow at the small record's shape "
              f"({RECALL_SMALL['n_events']} events, "
              f"{RECALL_SMALL['n_anomalies']} planted, "
              f"{RECALL_SMALL['n_sweeps']} sweeps, seed 0; run_scale's "
              f"sharded engine at block 2^17, the record's GibbsLDA at "
              f"2^14): D={m['n_docs']} V={m['n_vocab']}, K1 launches "
              f"{sample_count.launches}, {wall:.2f} s; recall "
              + ", ".join(f"top {d}: {rec[d]:.4f} (record "
                          f"{RECALL_SMALL_REF[d]})" for d in rec)
              + " (no bar: the record's beacon and exfil campaigns are "
              "built to blend)")
    no_fallback("sessions (b)")
    return total


def harness_oracle(dev):
    """The plain single-tenant path on tables already on `dev`."""
    import torch

    from onix_torch.models import scoring

    def oracle(tables, tenant, d, w, tol, max_results):
        th, ph = tables[tenant]
        return scoring.top_suspicious(
            th, ph, torch.from_numpy(d).to(dev), torch.from_numpy(w).to(dev),
            torch.ones(len(d), device=dev), tol=tol,
            max_results=max_results)
    return oracle


def phase_replicas(card: str, root: pathlib.Path, table) -> int:
    """(c) The phase-6 day model and the 63 harness tenants served by
    `serve_background` with serving.replicas=2 on the one card (K2
    pinned): /score answers equal the plain single-tenant path (phase
    6's check); a /feedback reaches both replicas before the next
    /score; after mark_down(0) every tenant re-homes off replica 0 and
    its answers do not change; K2 launches equal the replicas'
    dispatches. Peak allocated bytes at 1 and 2 replicas. Returns K2's
    launches."""
    import numpy as np
    import torch

    from onix_torch.checkpoint import load_model
    from onix_torch.config import OnixConfig
    from onix_torch.models import fused_serve as fs
    from onix_torch.oa.serve import serve_background
    from onix_torch.serving.replicas import ReplicaFront
    from onix_torch.store import model_name
    dev = "cuda"
    models_dir = root / "day" / "models"
    day = model_name("flow", SERVE_DATE)
    names = sorted(n for n in (p.relative_to(models_dir).with_suffix("")
                               .as_posix()
                               for p in models_dir.rglob("*.npz"))
                   if n.startswith(f"flow/{HARNESS_DATE.replace('-', '')}"))
    if len(names) != HARNESS_TENANTS:
        raise AssertionError(f"replicas (c): {len(names)} harness tenants "
                             "on disk")
    tables = {}
    for n in [day, *names]:
        ck = load_model(models_dir, n)
        tables[n] = tuple(torch.from_numpy(ck.arrays[k]).to(dev)
                          for k in ("theta", "phi_wk"))
    oracle = harness_oracle(dev)
    d_all, w_all, hour, _ = day_requests(table, OnixConfig().pipeline
                                         .dupfactor)
    rng = np.random.default_rng(12)
    reqs = [(day, f"h{h:02d}", d_all[hour == h], w_all[hour == h])
            for h in range(0, 24, 3)]
    reqs += [(names[int(t)], f"w{i}",
              rng.integers(0, HARNESS_D, HARNESS_EVENTS).astype(np.int32),
              rng.integers(0, HARNESS_V, HARNESS_EVENTS).astype(np.int32))
             for i, t in enumerate(rng.integers(0, HARNESS_TENANTS, 64))]

    def body(rs, window=True):
        return {"requests": [{"tenant": t, "window": win if window else None,
                              "doc_ids": d.tolist(), "word_ids": w.tolist()}
                             for t, win, d, w in rs]}

    peaks, launches = {}, 0
    for n_rep in (1, 2):
        cfg = OnixConfig()
        cfg.store.root = str(root / f"replicas_{n_rep}")
        cfg.serving.models_dir = str(models_dir)
        cfg.serving.replicas = n_rep
        cfg.serving.serve_form = "fused"
        cfg.validate()
        tol, m = cfg.pipeline.tol, cfg.pipeline.max_results
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fs.launches = 0
        server, port = serve_background(cfg)
        try:
            out, wall = http_json(port, "POST", "/score", body(reqs))
            for (t, win, d, w), res in zip(reqs, out["results"]):
                check_winners(res, oracle(tables, t, d, w, tol, m),
                              f"replicas={n_rep} {t} {win}")
            front = server.peek_bank_service()
            if n_rep == 1:
                torch.cuda.synchronize()
                peaks[1] = torch.cuda.max_memory_allocated() - base
                check_launches("replicas (c) one replica: K2", fs.launches,
                               front.bank.dispatches)
                launches += fs.launches
                continue
            if not isinstance(front, ReplicaFront) or \
                    len(front.replicas) != 2:
                raise AssertionError("replicas (c): no two-replica front")
            homes = {t: front.home(t) for t in tables}
            if len(set(homes.values())) != 2:
                raise AssertionError("replicas (c): one replica homes "
                                     "every tenant")
            # Feedback: 3 benign pairs of h00's winners.
            h0 = out["results"][0]
            _, _, d0, w0 = reqs[0]
            pairs = []
            for i in h0["indices"]:
                p = (int(d0[i]), int(w0[i]))
                if p not in pairs:
                    pairs.append(p)
                if len(pairs) == 3:
                    break
            epochs0 = [s.bank.epoch(day) for s in front.replicas]
            fb, _ = http_json(port, "POST", "/feedback", {
                "datatype": "flow", "date": SERVE_DATE,
                "rows": [{"ip": f"doc{dd}", "word": f"word{ww}", "label": 3,
                          "doc_id": dd, "word_id": ww}
                         for dd, ww in pairs]})
            epochs1 = [s.bank.epoch(day) for s in front.replicas]
            if not (fb["ok"] and all(b > a for a, b in zip(epochs0, epochs1))
                    and all(s.bank.get_filter(day) is not None
                            for s in front.replicas)):
                raise AssertionError(f"replicas (c): feedback reached "
                                     f"epochs {epochs0} -> {epochs1}")
            again, _ = http_json(port, "POST", "/score", body(reqs[:1]))
            res = again["results"][0]
            alive = {(int(d0[i]), int(w0[i])) for i in res["indices"]
                     if i >= 0}
            if res["cached"] or alive & set(pairs):
                raise AssertionError("replicas (c): the next /score after "
                                     "/feedback kept a dismissed pair")
            # Failover: replica 0 goes down; every tenant re-homes and
            # the harness answers do not change.
            front.mark_down(0)
            moved = sum(homes[t] == 0 for t in names)
            if any(front.home(t) == 0 for t in tables):
                raise AssertionError("replicas (c): a tenant still homes "
                                     "on the downed replica")
            after, _ = http_json(port, "POST", "/score",
                                 body(reqs[1:], window=False))
            for (t, win, d, w), res in zip(reqs[1:], after["results"]):
                check_winners(res, oracle(tables, t, d, w, tol, m),
                              f"after failover {t} {win}")
            stats, _ = http_json(port, "GET", "/bank/stats")
            torch.cuda.synchronize()
            peaks[2] = torch.cuda.max_memory_allocated() - base
            dispatches = [s.bank.dispatches for s in front.replicas]
        finally:
            server.shutdown()
            server.server_close()
    torch.cuda.synchronize()
    if not (fs.launches == sum(dispatches) == stats["dispatches"]
            and fs.launches > 0):
        raise AssertionError(f"replicas (c): K2 launched {fs.launches} "
                             f"times, the replicas dispatched {dispatches}")
    launches += fs.launches
    if stats["tiers"]["replicas_alive"] != 1:
        raise AssertionError(f"replicas (c): /bank/stats tiers "
                             f"{stats['tiers']}")
    say(card, f"replicas (c): 2 replicas on one card, {len(tables)} "
              f"tenants: /score equal to the plain path; /feedback reached "
              f"both replicas (epochs {epochs0} -> {epochs1}) and the next "
              f"/score dropped the 3 dismissed pairs; after mark_down(0) "
              f"{moved} harness tenants re-homed, answers unchanged; K2 "
              f"launches {fs.launches} = replica dispatches {dispatches}; "
              f"peak allocated bytes above the start: {peaks[1]} at 1 "
              f"replica, {peaks[2]} at 2")
    no_fallback("replicas (c)")
    return launches


def phase_harness(card: str) -> int:
    """(d) The load harness at the reference's bench shape under "auto":
    replay + sequential parity + the residency identity at capacity 8;
    events/s of both arms, the dispatch collapse, the resolved forms; K2
    launches equal the bank's dispatches, as the gate implies. Then the
    overload cell three times. Returns K2's launches."""
    import torch

    from onix_torch.models import fused_serve as fs
    from onix_torch.serving import load_harness as lh
    from onix_torch.utils.obs import counters
    spec = lh.HarnessSpec(**BENCH_SPEC, capacity=BENCH_CAPACITY)
    serve = fs.select_serve_form("auto", spec.events_per_request, "cuda")
    torch.cuda.synchronize()
    fs.launches = 0
    d0 = counters.get("bank.dispatch")
    t0 = time.perf_counter()
    out = lh.run_harness(spec)
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    dispatches = counters.get("bank.dispatch") - d0
    check_launches(f"harness (d): K2 (auto resolves {serve})", fs.launches,
                   dispatches if serve == "fused" else 0)
    if not (out["parity_bit_identical"]
            and out["capped_winners_identical_to_uncapped"]):
        raise AssertionError("harness (d): parity or residency identity")
    b, sq = out["banked"], out["sequential"]
    say(card, f"harness (d): {spec.n_tenants} tenants, D {spec.n_docs}, V "
              f"{spec.n_vocab}, K {spec.n_topics}, {spec.n_requests} "
              f"requests of {spec.events_per_request} events in batches of "
              f"{spec.batch_requests}, capacity {spec.capacity}, uncached: "
              f"banked {b['events_per_sec']} events/s, sequential "
              f"{sq['events_per_sec']} events/s "
              f"({out['speedup_banked_vs_sequential']}x); dispatches "
              f"{sq['dispatches']} -> {b['dispatches']}; evictions "
              f"{b['residency_churn']['evicts']}; resolved serve forms "
              f"{out['resolved_forms']}; parity and residency "
              f"identity hold; K2 launches {fs.launches} = bank dispatches "
              f"{dispatches}; {wall:.2f} s")
    launches = fs.launches
    for run in range(OVERLOAD_RUNS):
        torch.cuda.synchronize()
        fs.launches = 0
        cell = lh.overload_cell(lh.HarnessSpec(**BENCH_SPEC))
        o = cell["overload"]
        launches += fs.launches
        say(card, f"harness (d): overload cell run {run + 1}: "
                  f"max_queue_depth 1, {o['n_producers']} producers, "
                  f"{o['attempts']} attempts: {json.dumps(o['outcomes'])}; "
                  f"served p50 {o['served_p50_ms']} ms, p99 "
                  f"{o['served_p99_ms']} ms (uncontended p50 "
                  f"{cell['uncontended']['p50_ms']}, p99 "
                  f"{cell['uncontended']['p99_ms']} ms); offered "
                  f"{o['offered_factor_vs_sustainable']}x sustainable; "
                  f"{o['served_answers_checked']} served answers equal the "
                  f"unloaded ones; shed probes {cell['shed_probe']}")
    no_fallback("harness (d)")
    return launches


def phase_forms(card: str) -> int:
    """(e) The harness waves under serve_form "xla" and "fused": xla
    against fused by F0's contract (winners exact, scores within 8
    ulps); each arm's wave time. The ladder drill: on the card the
    ladder has no rung, so a K2 failure propagates. Returns K2's
    launches."""
    import numpy as np
    import torch

    from onix_torch.models import fused_serve as fs
    from onix_torch.serving import load_harness as lh
    spec = lh.HarnessSpec(**BENCH_SPEC)
    models, stream = lh.make_tenants(spec), lh.make_stream(spec)
    batch = stream[:spec.batch_requests]
    launches = 0
    answers, times = {}, {}
    for serve in ("xla", "fused"):
        svc = lh.build_service(spec, models, serve_form=serve)
        torch.cuda.synchronize()
        fs.launches = 0
        res = lh.replay(svc, stream, tol=spec.tol,
                        max_results=spec.max_results)
        torch.cuda.synchronize()
        check_launches(f"forms (e) {serve}: K2", fs.launches,
                       res["dispatches"] if serve == "fused" else 0)
        launches += fs.launches
        answers[serve] = [r.topk for r in res["results"]]
        # Timing calls are no serving path: their launches are not kept.
        times[serve] = event_ms(lambda: svc.bank.score_batch(
            batch, tol=spec.tol, max_results=spec.max_results), reps=10)
    worst = 0.0
    for i, (a, c) in enumerate(zip(answers["xla"], answers["fused"])):
        fin = np.isfinite(a.scores)
        if not (np.array_equal(a.indices, c.indices)
                and np.array_equal(fin, np.isfinite(c.scores))):
            raise AssertionError(f"forms (e): xla and fused winners differ "
                                 f"at request {i}")
        rel = np.abs(a.scores[fin] - c.scores[fin]) / c.scores[fin]
        worst = max(worst, float(rel.max(initial=0.0)))
    if worst > STREAM_ULPS:
        raise AssertionError(f"forms (e): xla against fused {worst:.3g} "
                             "relative")
    say(card, f"forms (e): {len(stream)} harness requests under xla and "
              f"fused: winners equal, scores within {worst:.3g} relative "
              f"(bound {STREAM_ULPS:.3g}); one wave of "
              f"{spec.batch_requests} x {spec.events_per_request} events "
              f"through score_batch, ms (CUDA events, median of 10): "
              + ", ".join(f"{k} {v:.4f}" for k, v in times.items()))
    no_fallback("forms (e)")

    # The ladder drill: K2's wrapper raises in-process. The ladder's
    # rung is plain PyTorch in place of K2, so on the card the failure
    # propagates whether the flag is on or off.
    real = fs.bank_score_fused

    def boom(*a, **kw):
        raise RuntimeError("fused_serve kernel launch failed: injected")
    propagated = []
    fs.bank_score_fused = boom
    try:
        for flag in (True, False):
            svc = lh.build_service(spec, models, serve_form="fused")
            svc.bank.degrade_form_fallback &= flag
            if svc.bank.degrade_form_fallback:
                raise AssertionError("forms (e): the ladder is armed on "
                                     "the card")
            try:
                svc.submit(batch, tol=spec.tol,
                           max_results=spec.max_results)
            except RuntimeError as e:
                propagated.append(str(e))
            else:
                raise AssertionError(f"forms (e): with the flag "
                                     f"{flag} the K2 failure did not "
                                     "propagate")
            if svc.bank.fallback_dispatches:
                raise AssertionError("forms (e): a wave fell back")
    finally:
        fs.bank_score_fused = real
    no_fallback("forms (e) drill")
    say(card, f"forms (e): ladder drill: with degrade_form_fallback on "
              f"(the default) and off the K2 failure propagates "
              f"({propagated[0]!r}); no wave fell back")
    return launches


def phase_rescore(card: str, root: pathlib.Path, table) -> int:
    """(e) The three `*_filtered_fast` dispatchers at the day's shapes
    with a 3-key filter, both forms: equal winners, one K2 launch a
    fused call. Returns K2's launches."""
    import numpy as np
    import torch

    from onix_torch.checkpoint import load_model
    from onix_torch.config import OnixConfig
    from onix_torch.feedback import rescore
    from onix_torch.feedback.filter import HostFilter, pack_pair, split_key
    from onix_torch.models import fused_serve as fs
    from onix_torch.models import scoring
    from onix_torch.store import model_name
    launches = 0

    # The filtered dispatchers at the day's shapes.
    cfg = OnixConfig()
    saved = load_model(root / "day" / "models", model_name("flow",
                                                           SERVE_DATE))
    theta = torch.from_numpy(saved.arrays["theta"]).cuda()
    phi = torch.from_numpy(saved.arrays["phi_wk"]).cuda()
    d_all, w_all, _, bundle = day_requests(table, cfg.pipeline.dupfactor)
    n = len(table)
    v = phi.shape[0]
    flat = d_all.astype(np.int64) * v + w_all
    tab = scoring.score_table(theta, phi).reshape(-1)
    t = {k: torch.from_numpy(np.ascontiguousarray(a)).cuda() for k, a in (
        ("si", flat[:n].astype(np.int32)), ("di", flat[n:].astype(np.int32)),
        ("d", d_all[:n]), ("w", w_all[:n]))}
    dw_hi, dw_lo = (torch.from_numpy(h.view(np.int32)).cuda()
                    for h in split_key(pack_pair(d_all[:n], w_all[:n])))
    sd_hi, sd_lo = (torch.from_numpy(h.view(np.int32)).cuda()
                    for h in split_key(pack_pair(d_all[:n], d_all[n:])))
    mask = torch.ones(n, device="cuda")
    m = cfg.pipeline.max_results
    calls = {
        "table_pair_bottom_k_filtered_fast": lambda f, form: (
            rescore.table_pair_bottom_k_filtered_fast(
                tab, t["si"], t["di"], t["w"], sd_hi, sd_lo, f, tol=1.0,
                max_results=m, serve_form=form)),
        "table_bottom_k_filtered_fast": lambda f, form: (
            rescore.table_bottom_k_filtered_fast(
                tab, t["si"], t["w"], dw_hi, dw_lo, f, tol=1.0,
                max_results=m, serve_form=form)),
        "top_suspicious_filtered_fast": lambda f, form: (
            rescore.top_suspicious_filtered_fast(
                theta, phi, t["d"], t["w"], mask, dw_hi, dw_lo, f, tol=1.0,
                max_results=m, serve_form=form)),
    }
    for name, call in calls.items():
        plain = call(HostFilter.empty().tables(device="cuda"), "xla")
        win = plain.indices.cpu().numpy()
        pairs = (pack_pair(d_all[:n], d_all[n:]) if "pair" in name
                 else pack_pair(d_all[:n], w_all[:n]))
        filt = HostFilter.empty().merged(
            word_suppress=w_all[win[:1]].astype(np.uint64),
            pair_suppress=pairs[win[5:6]],
            pair_boost=pairs[win[200:201]]).tables(device="cuda")
        got = {}
        for form in ("xla", "fused"):
            torch.cuda.synchronize()
            fs.launches = 0
            got[form] = call(filt, form)
            torch.cuda.synchronize()
            check_launches(f"rescore (e) {name} {form}: K2", fs.launches,
                           1 if form == "fused" else 0)
            launches += fs.launches
        a, b = got["xla"], got["fused"]
        if not (torch.equal(a.indices, b.indices)
                and torch.equal(a.scores, b.scores)):
            raise AssertionError(f"rescore (e): {name}: the forms differ")
        if torch.equal(a.indices, plain.indices):
            raise AssertionError(f"rescore (e): {name}: the filter moved "
                                 "nothing")
        say(card, f"rescore (e): {name}, N {n}, M {m}, 3-key filter: xla "
                  f"and fused equal bit for bit, one K2 launch for the "
                  f"fused call")
    no_fallback("rescore (e)")
    return launches


# -- phase 12 (f) -----------------------------------------------------------

# The serve gate's sweeps, in the gate's unit (events a scan): a table
# scan of N = 2^10 ... 2^24 events at the default pipeline M, on a table
# of the phase-5 day's size; a bank wave of the harness's 48 rows
# (padded to 64, as the bank pads them) at 2^6 ... 2^14 events a row,
# the per-lane count the bank keys the gate on.
GATE_LOG2 = range(10, 25)
GATE_BANK_LOG2 = range(6, 15)
GATE_M = 2000
GATE_PASSES = 3


def gate_position(n_events: float, grid: range) -> int:
    """Where an events threshold falls on a sweep's grid: 0 for anything
    up to its first size, else the exponent's step above it."""
    if n_events <= 1 << grid[0]:
        return 0
    return math.ceil(math.log2(n_events)) - grid[0]


def tail_start(holds: list, grid: range) -> int:
    """0 when `holds` is true at every swept N, else the smallest swept
    N from which it is true at every larger N; -1 when it is false at
    the largest."""
    if not holds[-1]:
        return -1
    first = len(holds) - 1
    while first > 0 and holds[first - 1]:
        first -= 1
    return 0 if first == 0 else 1 << grid[first]


def gate_crossover(passes: list, grid: range) -> int:
    """Where the fused arm wins at every larger N in every pass
    (`tail_start`)."""
    return tail_start([all(ps[i]["fused"] < ps[i]["other"] for ps in passes)
                       for i in range(len(grid))], grid)


def gate_row(grid: range) -> int | None:
    """The serve gate's threshold on a sweep's grid, read through the
    gate itself (`select_serve_form` under "auto" for the card), as
    `tail_start` of where it picks "fused"; None when it does not at the
    largest N."""
    from onix_torch.models import fused_serve as fs
    row = tail_start([fs.select_serve_form("auto", 1 << e, "cuda")
                      == "fused" for e in grid], grid)
    return None if row < 0 else row


def gate_sweep(card: str, label: str, other: str, grid: range, make) -> int:
    """Three passes of `make(n, first)` -> (fused, other) calls over the
    grid, each timed with CUDA events (median of 30 after warm calls);
    prints the table and returns the crossover."""
    passes = []
    for p in range(GATE_PASSES):
        row = []
        for e in grid:
            fused, alt = make(1 << e, p == 0)
            row.append({"fused": event_ms(fused), "other": event_ms(alt)})
        passes.append(row)
    got = gate_crossover(passes, grid)
    say(card, f"gate (f) {label}: N | fused ms (3 passes) | {other} ms "
              f"(3 passes)")
    for i, e in enumerate(grid):
        say(card, f"gate (f) {label}: 2^{e} | "
                  + " ".join(f"{ps[i]['fused']:.4f}" for ps in passes)
                  + " | " + " ".join(f"{ps[i]['other']:.4f}"
                                     for ps in passes))
    say(card, f"gate (f) {label}: crossover {got} events (the smallest N "
              f"from which fused wins at every larger N in all "
              f"{GATE_PASSES} passes; 0 = at every N, -1 = not at the "
              f"largest)")
    return got


def phase_gate(card: str) -> int:
    """(f) The serve gate's crossover, per consumer, on identical inputs
    per arm: the fused select with its two table gathers
    (`fused_table_pair_bottom_k`) against the torch f32 scan
    (`scoring.table_pair_bottom_k`) at N = 2^10 ... 2^24 events, and
    the bank's fused wave (`bank_score_fused`) against its xla wave
    (`model_bank._bank_score_gather`) on the harness's tenants at 2^6
    ... 2^14 events a row. Asserts that the arms agree at every N
    (exactly for the scan; winners exact and scores within 8 ulps for
    the bank), and that `_SERVE_FUSED_MIN_EVENTS["cuda"]` is each
    sweep's crossover within one power of two. Launches here compare
    arms and are not counted. Returns the scan's crossover."""
    import numpy as np
    import torch

    from onix_torch.models import fused_serve as fs
    from onix_torch.models import scoring
    from onix_torch.serving import load_harness as lh
    from onix_torch.serving import model_bank as mb
    g = torch.Generator(device="cuda")
    g.manual_seed(12)
    tab = torch.rand(MAIN_D * MAIN_V, generator=g, device="cuda")

    def scan_arms(n, first):
        si = torch.randint(0, tab.numel(), (n,), generator=g,
                           device="cuda", dtype=torch.int32)
        di = torch.randint(0, tab.numel(), (n,), generator=g,
                           device="cuda", dtype=torch.int32)

        def fused():
            return fs.fused_table_pair_bottom_k(
                tab, si, di, tol=1.0, max_results=GATE_M)

        def scan():
            return scoring.table_pair_bottom_k(
                tab, si, di, tol=1.0, max_results=GATE_M)
        if first:
            a, b = fused(), scan()
            if not (torch.equal(a.indices, b.indices)
                    and torch.equal(a.scores, b.scores)):
                raise AssertionError(f"gate: the scan arms differ at N={n}")
        return fused, scan

    # The bank's waves: every harness tenant resident in one shard, the
    # wave's rows padded as `ModelBank._score_wave` pads them.
    spec = lh.HarnessSpec(**BENCH_SPEC)
    models = lh.make_tenants(spec)
    bank = lh.build_service(spec, models, serve_form="fused").bank
    one = np.zeros(1, np.int32)
    bank.score_batch([mb.ScoreRequest(t, one, one) for t in models],
                     tol=spec.tol, max_results=spec.max_results)
    (shard,) = bank._shards.values()
    tenants = list(shard.lru)
    r = spec.batch_requests
    r_pad = 1 << (r - 1).bit_length()
    rng = np.random.default_rng(12)

    def bank_arms(n, first):
        slots = np.zeros(r_pad, np.int32)
        slots[:r] = [shard.lru[tenants[i % len(tenants)]] for i in range(r)]
        d = np.zeros((r_pad, n), np.int32)
        w = np.zeros((r_pad, n), np.int32)
        m = np.zeros((r_pad, n), np.float32)
        d[:r] = rng.integers(0, spec.n_docs, (r, n))
        w[:r] = rng.integers(0, spec.n_vocab, (r, n))
        m[:r] = 1.0
        lens = np.where(np.arange(r_pad) < r, n, 0).astype(np.int32)
        t = {k: torch.from_numpy(a).cuda() for k, a in (
            ("slots", slots), ("d", d), ("w", w), ("m", m), ("lens", lens))}
        args = (shard.theta, shard.phi, t["slots"], t["d"], t["w"], t["m"],
                spec.tol, None)

        def fused():
            return fs.bank_score_fused(*args, max_results=spec.max_results,
                                       row_len=t["lens"])

        def xla():
            return mb._bank_score_gather(*args,
                                         max_results=spec.max_results)
        if first:
            a, b = fused(), xla()
            fin = torch.isfinite(b.scores)
            rel = torch.where(fin, (a.scores - b.scores).abs()
                              / b.scores.abs(), torch.zeros_like(b.scores))
            if not (torch.equal(a.indices, b.indices)
                    and torch.equal(fin, torch.isfinite(a.scores))
                    and float(rel.max()) <= STREAM_ULPS):
                raise AssertionError(f"gate: the bank arms differ at "
                                     f"{n} events a row")
        return fused, xla

    got = gate_sweep(card, f"table scan, M {GATE_M}", "f32 scan",
                     GATE_LOG2, scan_arms)
    got_bank = gate_sweep(card, f"bank wave, {r} rows (padded to {r_pad}), "
                                f"M {spec.max_results}, events a row",
                          "xla wave", GATE_BANK_LOG2, bank_arms)
    rows = {label: gate_row(grid) for label, grid in (
        ("table scan", GATE_LOG2), ("bank wave", GATE_BANK_LOG2))}
    say(card, f"gate (f): the gate's cuda threshold on each grid "
              f"(select_serve_form): {rows}; crossover: table scan {got}, "
              f"bank wave {got_bank} events")
    for label, cross, grid in (("table scan", got, GATE_LOG2),
                               ("bank wave", got_bank, GATE_BANK_LOG2)):
        row = rows[label]
        if cross < 0:
            raise AssertionError(f"gate (f): {label}: the fused arm loses "
                                 "at the largest N")
        if row is None or abs(gate_position(row, grid)
                              - gate_position(cross, grid)) > 1:
            raise AssertionError(f"gate (f): the gate's cuda row {row} is "
                                 f"not the {label} crossover {cross} "
                                 "within one power of two")
    no_fallback("gate (f)")
    return got


# -- phase 13 ----------------------------------------------------------------

# K1's lane form: (label, lanes, B, K, V, D). The fleet week's two shape
# classes (docs/FLEET_r20_cpu.json week.padding: 100 lanes each of
# D_pad 256, V_pad 128 or 256 and one block of N_pad 2,048) at the
# week's K 10, each lane with its own ragged length; and an odd case of
# 3 lanes at K 7 with lanes of different lengths.
K1_LANE_SHAPES = [
    ("fleet class V 128", 100, 2048, 10, 128, 256),
    ("fleet class V 256", 100, 2048, 10, 256, 256),
    ("odd lanes", 3, 1000, 7, 300, 500),
]
# The fleet week at scripts/exp_fleet.py's defaults, cut from 200
# tenants to 50 (the victim is the middle tenant, t0025).
FLEET_WEEK = dict(days=7, tenants=50, n_events=600, n_sweeps=8,
                  n_topics=10, max_results=60, seed=3, plant=8,
                  poison_day=4)
FLEET_ARMS = dict(days=2, tenants=25)
# The daily week at scripts/exp_daily.py's defaults.
DAILY_WEEK = dict(days=7, n_events=60_000, datatypes=("flow", "dns"),
                  n_sweeps=24, n_topics=20, max_results=200, seed=0,
                  plant=60, dismiss_day=4, drift_max=0.5)
# The kill -9 drill: tests/test_daily.py's WEEK under its chaos plan.
DRILL_WEEK = ["--days", "7", "--events", "2000", "--sweeps", "4",
              "--topics", "10", "--max-results", "60", "--seed", "7",
              "--plants", "1:20,7:20"]
DRILL_CHAOS = ("daily:day@2=raise,daily:refit@2=raise,"
               "daily:ledger@3=raise,daily:ledger@5=torn,"
               "campaign:prepare@4=raise,fit:sweep@2=preempt,"
               "ckpt:save@1=torn")
# The campaign at scripts/exp_campaign.py's shape, cut to 40,000 events
# and dp 1.
CAMPAIGN = dict(n_events=40_000, n_sweeps=20, n_topics=20,
                max_results=200, seed=0, dp=1)
CAMPAIGN_CHAOS = "campaign:prepare@2=raise,fit:sweep@2=preempt,ckpt:save@1=torn"
# The SVI tolerance of the port (ROADMAP F9): torch and JAX digamma
# differ by up to 1.6e-5, so SVI tables are held to rtol 1e-4.
SVI_RTOL = 1e-4


def k1_lane_inputs(t: int, b: int, k: int, v: int, d: int,
                   use_gumbel: bool, seed: int):
    """K1 lane-form inputs on the card: each lane its own ids, ragged
    length (the rest padding: mask 0, topic K) and counts, the exact
    counts of its own tokens' topics, as a fleet lane holds them. Ids,
    mask and topics are [t, 3, b] (the call takes the strided views
    [:, 1], as the refit takes docs[:, i]); noise [t, b, k]."""
    import torch
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    dev = "cuda"

    def ints(hi, shape):
        return torch.randint(0, hi, shape, generator=g, device=dev,
                             dtype=torch.int32)

    docs, words, z_all = ints(d, (t, 3, b)), ints(v, (t, 3, b)), \
        ints(k, (t, 3, b))
    if t <= 3:
        lengths = [b * (i + 1) // t - 37 * i for i in range(t)]
    else:
        lengths = (b // 2 + torch.randint(0, b // 2 + 1, (t,),
                                          generator=g, device=dev)).tolist()
    mask = torch.zeros((t, 3, b), device=dev)
    for i, n in enumerate(lengths):
        mask[i, :, :n] = 1.0
    pad = mask == 0
    z_all[pad] = k
    docs[pad] = 0
    words[pad] = 0
    n_dk = torch.zeros((t, d, k), dtype=torch.int32, device=dev)
    n_wk = torch.zeros((t, v, k), dtype=torch.int32, device=dev)
    for i in range(t):
        real = mask[i, 1] > 0
        zr = z_all[i, 1][real].long()
        one = torch.ones_like(zr, dtype=torch.int32)
        n_dk[i].view(-1).index_add_(0, docs[i, 1][real].long() * k + zr, one)
        n_wk[i].view(-1).index_add_(0, words[i, 1][real].long() * k + zr,
                                    one)
    n_k = n_wk.sum(dim=1, dtype=torch.int32)
    noise = torch.stack([k1_noise(g, b, k, use_gumbel) for _ in range(t)])
    return n_dk, n_wk, n_k, z_all, noise, docs, words, mask, lengths


def lane_case(card: str, label: str, t: int, b: int, k: int, v: int, d: int,
              use_gumbel: bool, seed: int) -> dict:
    """K1's lane form at one shape: one call steps every lane, each with
    its own ids and mask (the strided views [:, 1] of [T, 3, B] stacks).
    From one snapshot it must equal its plain version exactly in z,
    n_dk, n_wk and n_k, leave the other rows of z alone, and give each
    lane what a one-lane call on that lane's slices gives. Times the
    call (CUDA events, median of 30) and the plain version, with the
    bound summed over the lanes. Returns the case's row."""
    import itertools

    import torch

    from onix_torch.models import sample_count as sc
    sampler = "gumbel" if use_gumbel else "race"
    (n_dk, n_wk, n_k, z_all, noise, docs, words, mask,
     lengths) = k1_lane_inputs(t, b, k, v, d, use_gumbel, seed=seed)
    kw = dict(alpha=ALPHA, eta=ETA, v_eta=v * ETA, use_gumbel=use_gumbel)
    snap = (n_dk, n_wk, n_k, z_all)

    def fresh():
        return [x.clone() for x in snap]

    def step(st, fn=sc.gibbs_block_step_, g=noise):
        fn(st[0], st[1], st[2], st[3][:, 1], g, docs[:, 1],
           words[:, 1], mask[:, 1], **kw)
    want = fresh()
    step(want, sc.gibbs_block_step_plain)
    got = fresh()
    before = sc.launches
    step(got)
    torch.cuda.synchronize()
    if sc.launches - before != 1:
        raise AssertionError(f"K1 lanes {label}/{sampler}: "
                             f"{sc.launches - before} calls, not 1")
    for name, a, e in zip(("n_dk", "n_wk", "n_k", "z"), got, want):
        if not torch.equal(a, e):
            bad = int((a != e).sum())
            raise AssertionError(
                f"K1 lanes {label}/{sampler}: {name} differs "
                f"from the plain step at {bad} places")
    if not torch.equal(got[3][:, [0, 2]], z_all[:, [0, 2]]):
        raise AssertionError(f"K1 lanes {label}/{sampler}: the "
                             "call wrote outside z[:, 1]")
    for i in range(t):
        one = [snap[0][i].clone(), snap[1][i].clone(),
               snap[2][i].clone(), snap[3][i, 1].clone()]
        sc.gibbs_block_step_(one[0], one[1], one[2], one[3],
                             noise[i].contiguous(),
                             docs[i, 1].contiguous(),
                             words[i, 1].contiguous(),
                             mask[i, 1].contiguous(), **kw)
        torch.cuda.synchronize()
        for name, a, e in zip(("n_dk", "n_wk", "n_k", "z"), one,
                              (got[0][i], got[1][i], got[2][i],
                               got[3][i, 1])):
            if not torch.equal(a, e):
                raise AssertionError(
                    f"K1 lanes {label}/{sampler}: lane {i} "
                    f"{name} differs from a one-lane call")
    n_moved = int(((want[3][:, 1] != z_all[:, 1])
                   & (mask[:, 1] > 0)).sum())
    err = max(float((a.double() - e.double()).abs().max())
              for a, e in zip(got, want))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 10)
    draws = itertools.cycle([
        torch.stack([k1_noise(gen, b, k, use_gumbel)
                     for _ in range(t)]) for _ in range(4)])
    work, plain_work = fresh(), fresh()
    ms = event_ms(lambda: step(work, g=next(draws)))
    plain_ms = event_ms(lambda: step(
        plain_work, sc.gibbs_block_step_plain, next(draws)),
        reps=10)
    parts = k1_profile(lambda: step(work, g=next(draws)))
    nbytes = ops = 0
    for i in range(t):
        _, _, nb_i, ops_i = step_bound(
            docs[i, 1], words[i, 1], z_all[i, 1], want[3][i, 1],
            mask[i, 1], k, use_gumbel)
        nbytes += nb_i
        ops += ops_i
    bound_ms, bound_by = bound_of(nbytes, ops)
    roofline_check(card, f"K1 lanes {label} T={t} {sampler}", nbytes,
                   ms)
    say(card, f"K1 lanes {label} T={t} B={b} K={k} V={v} D={d} "
              f"real tokens {min(lengths)}..{max(lengths)} "
              f"{sampler}: one call, z, n_dk, n_wk, n_k equal to "
              f"plain and to {t} one-lane calls ({n_moved} tokens "
              f"moved); call {ms:.5f} ms, plain {plain_ms:.5f} ms "
              f"(CUDA events, median); profiler: "
              f"{_fmt(parts) or 'no device time'}; bound "
              f"{bound_ms:.5f} ms by {bound_by} ({nbytes} B, "
              f"{ops} ops)")
    if not k1_pair(parts):
        raise AssertionError(f"K1 lanes {label}/{sampler}: the "
                             f"call ran {sorted(parts)}, not the "
                             "sample and apply kernels alone")
    return {"lanes": t, "B": b, "K": k, "V": v, "D": d, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "max_abs_err": err, "library_ms": None}


def phase_lane_step(card: str) -> dict:
    """(a) K1's lane form at `K1_LANE_SHAPES`, both samplers
    (`lane_case`). Returns the first fleet class's Gumbel figures for
    K1's `lanes` entry."""
    out = {}
    for si, (label, t, b, k, v, d) in enumerate(K1_LANE_SHAPES):
        for use_gumbel in (True, False):
            row = lane_case(card, label, t, b, k, v, d, use_gumbel,
                            seed=131 + si)
            if si == 0 and use_gumbel:
                out = row
    return out


def plant_hits(manifest: dict, day: int) -> dict:
    rec = manifest["days"][day - 1]
    return {t: b["winners"]["planted_in_bottom_k"]
            for t, b in rec["tenants"].items() if b.get("status") == "ok"}


def fleet_identity(manifest: dict) -> list:
    """A fleet run's per-day tenant ledger bodies without the walls and
    resume flags: what must be identical across arms."""
    return [{"day": rec["day"],
             "tenants": {t: {k: v for k, v in b.items()
                             if k not in ("timing", "resumed")}
                         for t, b in rec["tenants"].items()}}
            for rec in manifest["days"]]


def k1_calls(dispatches: list) -> int:
    """The K1 calls a fleet run's class refits make: sweeps x blocks
    per pass, once per distinct device of the class's mesh (fleet arm;
    one without a mesh) or once per lane (sequential arm)."""
    return sum(dp["sweeps"] * dp["blocks"]
               * (dp["devices"] if dp["batched"] else dp["lanes"])
               for dp in dispatches)


def phase_fleet(card: str, root: pathlib.Path,
                week: dict = FLEET_WEEK, arms: dict = FLEET_ARMS) -> int:
    """(b) The fleet week at scripts/exp_fleet.py's defaults, with its
    bars; K1's launches equal sweeps x blocks summed over the week's
    class refits (the manifest's `dispatches`), K2's the ok tenant-days'
    selections. (c) The fleet arm against the sequential arm at
    `arms`' tenants and days: identical ledger bodies and lineage, and
    the sequential arm's K1 calls the fleet arm's times each class's
    lanes. Returns (the week's K1 launches, K1 and K2 launches of the
    whole phase)."""
    import torch

    from onix_torch.models import fused_serve, sample_count
    from onix_torch.pipelines.fleet import (run_fleet, tenant_lineage,
                                            tenant_name)
    from onix_torch.utils.obs import counters
    days, n_t = week["days"], week["tenants"]
    plants = {1: week["plant"], days: week["plant"]}
    kw = dict(n_events=week["n_events"], n_sweeps=week["n_sweeps"],
              n_topics=week["n_topics"], max_results=week["max_results"],
              seed=week["seed"])
    victim = tenant_name(n_t // 2)
    torch.cuda.synchronize()
    sample_count.launches = fused_serve.launches = 0
    t0 = time.perf_counter()
    m = run_fleet(days, n_t, root / "fleet_week", plants=plants,
                  poison_feed={(victim, week["poison_day"])}, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k2 = sample_count.launches, fused_serve.launches
    agg = m["aggregate"]
    if agg["failed_tenant_days"] != 1 \
            or agg["ok_tenant_days"] != days * n_t - 1:
        raise AssertionError(f"fleet week: {agg}")
    lin = tenant_lineage(m, victim)
    ok_days = [r["day"] for r in lin]
    pd_ = week["poison_day"]
    after = ok_days.index(pd_ + 1)
    if pd_ in ok_days or lin[after]["parent_digest"] \
            != lin[after - 1]["content_sha256"]:
        raise AssertionError(f"fleet week: {victim} not reparented over "
                             f"day {pd_}: {ok_days}")
    cold, warm = plant_hits(m, 1), plant_hits(m, days)
    lost = [(t, hc, warm[t]) for t, hc in cold.items()
            if warm[t] < hc - max(2, round(0.5 * max(hc, 1)))
            or (hc > 0 and warm[t] == 0)]
    if lost:
        raise AssertionError(f"fleet week: warm chains lost plants: "
                             f"{lost[:5]}")
    mean_cold = sum(cold.values()) / len(cold)
    mean_warm = sum(warm.values()) / len(warm)
    if mean_warm < 0.8 * mean_cold:
        raise AssertionError(f"fleet week: mean warm {mean_warm} < 0.8 x "
                             f"cold {mean_cold}")
    check_launches("fleet week K1", k1, k1_calls(m["dispatches"]))
    check_launches("fleet week K2", k2, agg["ok_tenant_days"])
    say(card, f"fleet week: {n_t} tenants x {days} days, {kw['n_events']} "
              f"events, K {kw['n_topics']}, {kw['n_sweeps']} sweeps: "
              f"{agg['ok_tenant_days']} ok tenant-days, 1 failed "
              f"({victim} day {pd_}, reparented: {ok_days}); plants day 1 "
              f"mean {mean_cold:.2f}, day {days} warm mean "
              f"{mean_warm:.2f}, no tenant below its bar; classes "
              f"{json.dumps(m['padding']['class_shapes'])}; K1 launches "
              f"{k1} ({len(m['dispatches'])} class refits), K2 launches "
              f"{k2}; wall {wall:.2f} s, fit wall {agg['fit_wall_s']} s; "
              f"refit span {telemetry_span_s('fleet.refit'):.2f} s, day "
              f"span {telemetry_span_s('fleet.day'):.2f} s")
    n_a, d_a = arms["tenants"], arms["days"]
    got = {}
    fused_serve.launches = 0
    for batched in (True, False):
        for ns in ("fleet", "campaign", "daily", "faults", "ckpt"):
            counters.reset(ns)
        torch.cuda.synchronize()
        sample_count.launches = 0
        t0 = time.perf_counter()
        got[batched] = (run_fleet(d_a, n_a, root / f"fleet_arm_{batched}",
                                  plants={1: week["plant"]},
                                  batched=batched, **kw),
                        sample_count.launches, time.perf_counter() - t0)
    (mf, k1f, wf), (ms, k1s, ws) = got[True], got[False]
    if fleet_identity(mf) != fleet_identity(ms):
        raise AssertionError("fleet arm and sequential arm differ")
    for u in range(n_a):
        if tenant_lineage(mf, tenant_name(u)) \
                != tenant_lineage(ms, tenant_name(u)):
            raise AssertionError(f"lineage of {tenant_name(u)} differs "
                                 "between the arms")
    for a, b in zip(mf["dispatches"], ms["dispatches"]):
        if (a["class"], a["lanes"], a["sweeps"]) \
                != (b["class"], b["lanes"], b["sweeps"]):
            raise AssertionError(f"the arms refit other classes: {a} {b}")
    check_launches("fleet arm K1", k1f, k1_calls(mf["dispatches"]))
    fleet_refit_breakdown(card)
    check_launches("sequential arm K1", k1s, k1_calls(ms["dispatches"]))
    say(card, f"fleet arms: {n_a} tenants x {d_a} days: ledger bodies and "
              f"lineage identical; K1 calls fleet {k1f}, sequential "
              f"{k1s} (each class refit's lanes x the fleet's); fit wall "
              f"fleet {mf['aggregate']['fit_wall_s']} s, sequential "
              f"{ms['aggregate']['fit_wall_s']} s; run wall {wf:.2f} s, "
              f"{ws:.2f} s")
    return k1, k1 + k1f + k1s, k2 + fused_serve.launches


def fleet_refit_breakdown(card: str, lanes: int = 100, n_tokens: int = 1200,
                          n_docs: int = 200, n_vocab: int = 120,
                          k: int = 10, sweeps: int = 8,
                          device: str = "cuda") -> None:
    """Where a fleet class refit's wall goes: one cold refit of `lanes`
    random tenants of the week's first class (D_pad 256, V_pad 128, one
    block of 2,048) against its parts timed alone — the count build,
    the lanes' noise draws for every sweep, K1's calls, and the
    lane-by-lane estimates and ll. Host clock around work that ends in
    a synchronize; the median of 5."""
    import numpy as np
    import torch

    from onix_torch.config import LDAConfig
    from onix_torch.convert import fleet_class_from_numpy
    from onix_torch.models import fleet_gibbs as fg
    from onix_torch.models import sample_count
    rng = np.random.default_rng(7)
    def ids(hi):
        return rng.integers(0, hi, n_tokens).astype(np.int32)
    tds = [fg.TenantDay(name=f"t{u}", uid=u, docs=ids(n_docs),
                        words=ids(n_vocab), n_docs=n_docs, n_vocab=n_vocab)
           for u in range(lanes)]
    (sc,) = fg.stack_tenants(tds, k_topics=k, seed=1, day=1)
    a = fleet_class_from_numpy(sc, device)
    d_pad, v_pad, _ = sc.key
    cfg = LDAConfig(n_topics=k, n_sweeps=sweeps, burn_in=sweeps // 2)
    b = int(a["docs"].shape[2])

    def wall(fn, reps=5):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return statistics.median(times) * 1e3

    def refit():
        fg.refit_lanes(cfg, a["z0"], a["docs"], a["words"], a["mask"],
                       a["fb_docs"], a["fb_words"], a["fb_weights"],
                       fg.LaneNoise(a["keys"], device), n_docs=d_pad,
                       n_vocab=v_pad, use_gumbel=True)
    counts = fg.lane_counts(a["z0"], a["docs"], a["words"], d_pad, v_pad, k)
    noise = fg.LaneNoise(a["keys"], device)
    draws = [noise.block(b, k, True) for _ in range(2)]
    before = sample_count.launches
    ms_all = wall(refit)
    k1_per = (sample_count.launches - before) // 5
    ms_counts = wall(lambda: fg.lane_counts(a["z0"], a["docs"], a["words"],
                                            d_pad, v_pad, k))
    ms_noise = wall(lambda: [noise.block(b, k, True)
                             for _ in range(sweeps)])
    st = [x.clone() for x in counts] + [a["z0"].clone()]
    kw = dict(alpha=cfg.alpha, eta=cfg.eta, v_eta=v_pad * cfg.eta,
              use_gumbel=True)
    ms_k1 = wall(lambda: [sample_count.gibbs_block_step_(
        st[0], st[1], st[2], st[3][:, 0], draws[i % 2], a["docs"][:, 0],
        a["words"][:, 0], a["mask"][:, 0], **kw) for i in range(sweeps)])
    ndk_f, nwk_f = counts[0].float(), counts[1].float()
    ms_est = wall(lambda: fg._lanes_estimates_ll(
        ndk_f, nwk_f, a["docs"], a["words"], a["mask"], alpha=cfg.alpha,
        eta=cfg.eta))
    say(card, f"fleet class refit breakdown ({lanes} lanes, {sweeps} cold "
              f"sweeps, {k1_per} K1 calls; host clock, median of 5): "
              f"refit {ms_all:.2f} ms = count build {ms_counts:.2f} + "
              f"noise draws {ms_noise:.2f} ({sweeps} x {lanes} lanes) + K1 "
              f"calls {ms_k1:.2f} + estimates and ll, twice "
              f"{2 * ms_est:.2f} (lane by lane) + the rest")


def telemetry_span_s(name: str) -> float:
    """Seconds summed over the spans `name` in the telemetry
    histograms."""
    from onix_torch.utils import telemetry
    h = telemetry.histograms.get(f"span.{name}")
    return 0.0 if h is None else float(h.snapshot().get("sum", 0.0))


def daily_walls(manifest: dict) -> dict:
    return {rec["day"]: sum(w["fit"] for w in
                            rec["timing"]["stage_walls_s"].values())
            for rec in manifest["days"] if rec.get("status") == "ok"}


def daily_fit_breakdown(card: str, root: pathlib.Path, week: dict) -> None:
    """Where a daily fit's wall goes, cold against warm, on the warm
    arm's day-2 flow feed (day 1's edges, day 1's model as the prior):
    the fit's own walls (`ShardedGibbsLDA.fit`: layout, init, sweeps,
    estimates) at the week's cold budget and at its warm one from the
    φ̂ prior, with the warm arm's host steps around the fit (mapping the
    prior, the drift check). Host clock, each fit ending in a copy to
    the host."""
    import dataclasses

    from onix_torch import checkpoint
    from onix_torch.config import LDAConfig
    from onix_torch.parallel.mesh import make_mesh
    from onix_torch.parallel.sharded_gibbs import ShardedGibbsLDA
    from onix_torch.pipelines.campaign import (_prepare, map_phi_prior,
                                               phi_topic_drift,
                                               vocab_word_keys)
    from onix_torch.pipelines.daily import _load_edges
    from onix_torch.pipelines.synth import SYNTH_ARRAYS
    arm = root / "daily_warm"
    n = week["n_events"]
    prep = _prepare("flow", n, max(120, min(200_000, n // 500)), 0,
                    week["seed"], SYNTH_ARRAYS,
                    edges=_load_edges(arm, ("flow",))["flow"])
    prior = checkpoint.load_model(arm / "models", "flow/day-001")
    keys = vocab_word_keys(prep.bundle)
    t0 = time.perf_counter()
    init_phi, _ = map_phi_prior(keys, prior.arrays["phi_wk"],
                                prior.arrays["word_key"])
    map_s = time.perf_counter() - t0
    s = week["n_sweeps"]
    cfg = LDAConfig(n_topics=week["n_topics"], n_sweeps=s,
                    burn_in=max(1, s // 2), block_size=1 << 17,
                    seed=week["seed"])
    wcfg = dataclasses.replace(cfg, n_sweeps=max(2, s // 2), burn_in=1)
    mesh = make_mesh(1, 1)
    corpus = prep.bundle.corpus
    walls = {}
    for name, c, phi in (("cold", cfg, None), ("warm", wcfg, init_phi)):
        t0 = time.perf_counter()
        fit = ShardedGibbsLDA(c, corpus.n_vocab, mesh=mesh).fit(
            corpus, init_phi=phi)
        walls[name] = dict(fit["walls"], total=time.perf_counter() - t0)
    t0 = time.perf_counter()
    phi_topic_drift(fit["phi_wk"], keys, prior.arrays["phi_wk"],
                    prior.arrays["word_key"])
    drift_s = time.perf_counter() - t0

    def fmt(w):
        return ", ".join(f"{k} {v * 1e3:.1f}" for k, v in w.items())
    say(card, f"daily fit breakdown, day-2 flow feed ({corpus.n_tokens} "
              f"tokens; ms, host clock): cold {cfg.n_sweeps} sweeps: "
              f"{fmt(walls['cold'])}; warm {wcfg.n_sweeps} sweeps: "
              f"{fmt(walls['warm'])}; around the warm fit: prior map "
              f"{map_s * 1e3:.1f}, drift check {drift_s * 1e3:.1f}")


def phase_daily(card: str, root: pathlib.Path,
                week: dict = DAILY_WEEK) -> tuple:
    """(d) The daily week at scripts/exp_daily.py's defaults as the
    cold control and the warm arm, with the experiment's bars and one
    K2 launch a datatype-day. (The kill -9 drill is `drill_process` and
    `check_drill`.) Returns the arms' (K1, K2) launches."""
    import pandas as pd
    import torch

    from onix_torch.config import DailyConfig
    from onix_torch.models import fused_serve, sample_count
    from onix_torch.pipelines.daily import run_daily
    from onix_torch.utils.obs import counters
    days, dts = week["days"], week["datatypes"]
    kw = dict(n_events=week["n_events"], datatypes=dts,
              n_sweeps=week["n_sweeps"], n_topics=week["n_topics"],
              max_results=week["max_results"], seed=week["seed"],
              plants={1: week["plant"], days: week["plant"]},
              collect_winner_pairs=True)

    def arm(name, daily, feedback=None):
        for ns in ("daily", "campaign", "faults", "ckpt"):
            counters.reset(ns)
        torch.cuda.synchronize()
        sample_count.launches = fused_serve.launches = 0
        t0 = time.perf_counter()
        m = run_daily(days, root / f"daily_{name}", daily=daily,
                      feedback=feedback, **kw)
        torch.cuda.synchronize()
        if m["aggregate"]["ok_days"] != days:
            raise AssertionError(f"daily {name}: {m['aggregate']}")
        check_launches(f"daily {name} K2", fused_serve.launches,
                       days * len(dts))
        return m, sample_count.launches, time.perf_counter() - t0
    cold, k1_cold, w_cold = arm("cold", DailyConfig(force_cold=True,
                                                    day_seed_stride=0))
    d_day = week["dismiss_day"]
    dismiss_dt = dismissed = None
    for dt in dts:
        nxt = set(cold["days"][d_day]["winners"][dt]["indices"])
        for wp in cold["days"][d_day - 1]["winners"][dt]["winner_pairs"]:
            if wp["event"] in nxt:
                dismiss_dt, dismissed = dt, wp
                break
        if dismissed:
            break
    if dismissed is None:
        raise AssertionError("daily: no recurring day-4 winner to dismiss")
    recurred = [d for d in range(d_day + 1, days) if dismissed["event"]
                in cold["days"][d - 1]["winners"][dismiss_dt]["indices"]]
    fb = pd.DataFrame([{"ip": ip, "word": word}
                       for ip, word in dismissed["pairs"]])
    warm, k1_warm, w_warm = arm(
        "warm", DailyConfig(drift_max=week["drift_max"],
                            day_seed_stride=0), feedback={d_day + 1: fb})
    cw, ww = daily_walls(cold), daily_walls(warm)
    cold_tail = sum(cw[d] for d in range(2, days + 1))
    warm_tail = sum(ww[d] for d in range(2, days + 1))
    forms = {d: {dt: warm["days"][d - 1]["refit"][dt]["form"]
                 for dt in dts} for d in range(2, days + 1)}
    if any(f != "warm" for v in forms.values() for f in v.values()):
        raise AssertionError(f"daily: warm arm fell back: {forms}")
    parity = {}
    for day in (1, days):
        for dt in dts:
            hc = cold["days"][day - 1]["winners"][dt]["planted_in_bottom_k"]
            hw = warm["days"][day - 1]["winners"][dt]["planted_in_bottom_k"]
            parity[f"{day}/{dt}"] = (hc, hw)
            if hw < hc - max(2, round(0.15 * max(hc, 1))) or hw == 0:
                raise AssertionError(f"daily day {day} {dt}: warm lost "
                                     f"the plant ({hw} vs {hc})")
    if not recurred:
        raise AssertionError("daily: the control lost the dismissed "
                             "winner on its own")
    for d in recurred:
        if dismissed["event"] in \
                warm["days"][d - 1]["winners"][dismiss_dt]["indices"]:
            raise AssertionError(f"daily: dismissed event back on day {d}")
    say(card, f"daily week: {days} days x {week['n_events']} events "
              f"{'+'.join(dts)}, cold {week['n_sweeps']} sweeps, warm "
              f"{warm['days'][1]['refit'][dts[0]]['warm_sweeps']}: every "
              f"day ok, warm on days 2-{days}; plants (cold, warm) "
              f"{json.dumps(parity)}; {dismiss_dt} event "
              f"{dismissed['event']} dismissed on day {d_day}, absent from "
              f"the warm winners on days {recurred}; fit walls days 2-"
              f"{days}: cold {cold_tail:.3f} s, warm {warm_tail:.3f} s, "
              f"cold/warm {cold_tail / max(warm_tail, 1e-9):.3f} (the "
              f"reference's CPU record: 1.584); K1 launches cold "
              f"{k1_cold}, warm {k1_warm}; run walls {w_cold:.2f} s, "
              f"{w_warm:.2f} s")
    launches = (k1_cold + k1_warm, 2 * days * len(dts))
    daily_fit_breakdown(card, root, week)
    return launches


def drill_process(drill: pathlib.Path, device: str) -> tuple:
    """The kill -9 drill's two supervisor runs: `python -m
    onix_torch.pipelines.daily --device <device>` at DRILL_WEEK under
    DRILL_CHAOS, killed with SIGKILL once day 1 is in its ledger, then
    restarted to the end. Returns (seconds to the kill, ledger days
    before the restart, the restart's summary). Runs beside the other
    lifecycle work, which shares nothing with it."""
    import os
    import signal
    argv = [sys.executable, "-m", "onix_torch.pipelines.daily",
            "--root", str(drill), *DRILL_WEEK, "--device", device]
    env = dict(os.environ, PYTHONPATH=str(HERE),
               ONIX_FAULT_PLAN=DRILL_CHAOS)
    t0 = time.perf_counter()
    proc = subprocess.Popen(argv, env=env, cwd=str(HERE),
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        with bounded("drill day 1 in the ledger",
                     "the daily supervisor's day 1") as lim:
            deadline = time.monotonic() + lim
            while not (drill / "ledger" / "day-001.json").exists():
                if proc.poll() is not None:
                    raise AssertionError(
                        "drill: the supervisor exited before the kill:\n"
                        + proc.communicate()[0][-2000:])
                if time.monotonic() > deadline:
                    raise TimeoutError("day 1 never reached the ledger")
                time.sleep(0.02)
        os.kill(proc.pid, signal.SIGKILL)
        with bounded("drill kill", "the killed supervisor's exit") as lim:
            proc.wait(timeout=lim)
    finally:
        if proc.poll() is None:
            proc.kill()
            with bounded("drill kill", "the killed supervisor's exit") \
                    as lim:
                proc.wait(timeout=lim)
    killed_at = time.perf_counter() - t0
    if proc.returncode == 0:
        raise AssertionError("drill: the supervisor finished before the "
                             "kill")
    n_before = len(list((drill / "ledger").glob("day-*.json")))
    with bounded("drill restart", "the restarted daily supervisor") as lim:
        out = subprocess.run(argv, env=env, cwd=str(HERE),
                             capture_output=True, text=True, timeout=lim)
    if out.returncode != 0:
        raise AssertionError("drill: the restart failed:\n"
                             + out.stdout[-2000:] + out.stderr[-2000:])
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    if summary["ok_days"] != 7 or summary["resumed_days"] < 1:
        raise AssertionError(f"drill: restart summary {summary}")
    return killed_at, n_before, summary


def check_drill(card: str, root: pathlib.Path, killed_at: float,
                n_before: int, summary: dict) -> None:
    """The drill's ledger bodies equal an uninterrupted in-process run's
    at the same week."""
    from onix_torch.pipelines.daily import DayLedger, run_daily
    from onix_torch.utils import faults
    faults.reset()
    control = run_daily(7, root / "drill_control", n_events=2000,
                        datatypes=("flow",), n_sweeps=4, n_topics=10,
                        max_results=60, seed=7, plants={1: 20, 7: 20})
    led = DayLedger(root / "drill" / "ledger")
    for i, rec in enumerate(control["days"], start=1):
        got = led.read(i)
        want = {k: v for k, v in rec.items()
                if k not in ("timing", "resumed")}
        if got is None or got["body"] != want:
            raise AssertionError(f"drill: day {i} differs from the "
                                 "uninterrupted run")
    say(card, f"kill -9 drill: killed {killed_at:.1f} s in with "
              f"{n_before} day(s) in the ledger, restarted "
              f"({summary['resumed_days']} resumed): 7 ledger bodies equal "
              f"the uninterrupted run's; restart wall "
              f"{summary['wall_s']} s in-run")


def phase_campaign(card: str, root: pathlib.Path,
                   shape: dict = CAMPAIGN) -> None:
    """(e) The campaign over flow, dns and proxy: the overlapped arm
    and the sequential arm give identical winners, the OccupancyClock's
    stage-sum identity holds in both, and the chaos plan resumes to the
    same winners; one K2 launch a datatype per run. Returns the runs'
    (K1, K2) launches."""
    import torch

    from onix_torch.models import fused_serve, sample_count
    from onix_torch.pipelines.campaign import run_campaign, winners_identical
    from onix_torch.utils import faults
    from onix_torch.utils.obs import counters
    runs = {}
    k1_all = k2_all = 0
    for name, extra in (("sequential", dict(overlap=False)),
                        ("overlapped", dict(overlap=True)),
                        ("chaos", dict(overlap=True,
                                       resume_dir=root / "campaign_chaos"))):
        for ns in ("campaign", "faults", "ckpt"):
            counters.reset(ns)
        plan = faults.install_plan(CAMPAIGN_CHAOS) if name == "chaos" \
            else None
        torch.cuda.synchronize()
        sample_count.launches = fused_serve.launches = 0
        t0 = time.perf_counter()
        try:
            m = run_campaign(**shape, **extra)
        finally:
            pending = plan.pending() if plan is not None else []
            faults.reset()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if pending:
            raise AssertionError(f"campaign chaos: rules never fired: "
                                 f"{pending}")
        if not m["aggregate"]["stage_sum_identity_ok"]:
            raise AssertionError(f"campaign {name}: stage-sum identity")
        check_launches(f"campaign {name} K2", fused_serve.launches, 3)
        k1_all += sample_count.launches
        k2_all += fused_serve.launches
        hits = {dt: v["planted_in_bottom_k"]
                for dt, v in m["per_datatype"].items()}
        if min(hits.values()) <= 0:
            raise AssertionError(f"campaign {name}: planted hits {hits}")
        runs[name] = m
        occ = m["occupancy"]
        walls = m["orchestration"]["per_datatype_stage_walls_s"]
        say(card, f"campaign {name}: {shape['n_events']} events x "
                  f"flow+dns+proxy, {shape['n_sweeps']} sweeps: planted "
                  f"hits {hits}; wall {wall:.2f} s, driver span "
                  f"{m['aggregate']['wall_seconds']} s, barrier stall "
                  f"{m['aggregate']['barrier_stall_s']} s, union busy "
                  f"{occ['union_busy_s']} s, overlap {occ['overlap_s']} s; "
                  f"stage walls {json.dumps(walls)}; K1 launches "
                  f"{sample_count.launches}, fit preemptions "
                  f"{m['aggregate']['fit_preemptions']}")
    for name in ("overlapped", "chaos"):
        if not winners_identical(runs["sequential"], runs[name]):
            raise AssertionError(f"campaign {name}: winners differ from "
                                 "the sequential arm")
    if runs["chaos"]["aggregate"]["fit_preemptions"] < 1:
        raise AssertionError("campaign chaos: no preemption recovered")
    return k1_all, k2_all


def phase_online(card: str, root: pathlib.Path, table) -> int:
    """(f) `OnlineUpdater.nudge_and_save` on phase 5's saved model (a
    copy): the epoch rises by one, the dismissed pair's score rises,
    the tables and every score of the window equal a CPU nudge's within
    the SVI rtol, and a live bank over the models dir serves the new
    epoch uncached. Prints how far the pairs that share neither the
    dismissed doc nor its word moved. Returns the bank's K2
    launches."""
    import shutil

    import numpy as np
    import torch

    from onix_torch import checkpoint
    from onix_torch.config import FeedbackConfig, LDAConfig
    from onix_torch.feedback.online import OnlineUpdater
    from onix_torch.models import fused_serve
    from onix_torch.serving.model_bank import (BankService, ModelBank,
                                               ScoreRequest, TenantModel)
    name = "flow/20160708"
    models = root / "online_models"
    src = checkpoint.model_path(root / "day" / "models", name)
    dst = checkpoint.model_path(models, name)
    dst.parent.mkdir(parents=True, exist_ok=True)
    shutil.copy(src, dst)
    shutil.copy(src.with_suffix(".json"), dst.with_suffix(".json"))
    m0 = checkpoint.load_model(models, name)
    d, w, hour, _ = day_requests(table, 1000)
    sel = hour == 0
    req = ScoreRequest(name, d[sel], w[sel], window="h0")

    def loader(t):
        m = checkpoint.load_model(models, t)
        return None if m is None else TenantModel(
            m.arrays["theta"], m.arrays["phi_wk"],
            epoch=int(m.meta.get("model_epoch", 0)))
    bank = ModelBank(capacity=2, loader=loader,
                     epoch_loader=lambda t: checkpoint.model_meta_epoch(
                         models, t))
    svc = BankService(bank)
    torch.cuda.synchronize()
    k2_before = fused_serve.launches
    (r1,) = svc.score([req], tol=1.0, max_results=64)
    (r2,) = svc.score([req], tol=1.0, max_results=64)
    if not r2.cached:
        raise AssertionError("online: the repeat was not cached")
    e0 = bank.epoch(name)
    top = int(r2.topk.indices[0])
    dd = np.array([req.doc_ids[top]], np.int32)
    dw = np.array([req.word_ids[top]], np.int32)
    lab = np.array([3])
    lda, fb = LDAConfig(n_topics=MAIN_K), FeedbackConfig()
    t0 = time.perf_counter()
    res = OnlineUpdater(lda, fb).nudge_and_save(models, name, dd, dw, lab)
    torch.cuda.synchronize()
    nudge_s = time.perf_counter() - t0
    cpu = OnlineUpdater(lda, fb, device="cpu").nudge(
        m0.arrays["theta"], m0.arrays["phi_wk"], dd, dw, lab)
    for what, a, b in (("theta", res.theta, cpu.theta),
                       ("phi_wk", res.phi_wk, cpu.phi_wk)):
        if not np.allclose(a, b, rtol=SVI_RTOL, atol=1e-7):
            raise AssertionError(f"online: the card's {what} differs from "
                                 "the CPU nudge beyond the SVI rtol")
    m1 = checkpoint.load_model(models, name)
    if int(m1.meta["model_epoch"]) != int(m0.meta.get("model_epoch", 0)) + 1:
        raise AssertionError(f"online: epoch {m1.meta['model_epoch']}")

    def p(th, ph, dd_, ww_):
        return (th[dd_] * ph[ww_]).sum(axis=1)
    th0, ph0 = m0.arrays["theta"], m0.arrays["phi_wk"]
    if not (p(res.theta, res.phi_wk, dd, dw) > p(th0, ph0, dd, dw)).all():
        raise AssertionError("online: the dismissed pair's score fell")
    # Every score of the window under the card's tables is the CPU
    # nudge's within twice the SVI rtol (a score multiplies a θ row into
    # a φ row, each held to the rtol); pairs sharing neither the
    # dismissed doc nor its word show how far the rest of the model
    # moved.
    win_card = p(res.theta, res.phi_wk, req.doc_ids, req.word_ids)
    win_cpu = p(cpu.theta, cpu.phi_wk, req.doc_ids, req.word_ids)
    if not np.allclose(win_card, win_cpu, rtol=2 * SVI_RTOL, atol=0):
        raise AssertionError("online: the window's scores differ from the "
                             "CPU nudge's beyond the SVI rtol")
    other = (req.doc_ids != dd[0]) & (req.word_ids != dw[0])
    rel = win_card[other] / p(th0, ph0, req.doc_ids[other],
                              req.word_ids[other])
    (r3,) = svc.score([req], tol=1.0, max_results=64)
    torch.cuda.synchronize()
    if r3.cached or bank.epoch(name) <= e0:
        raise AssertionError("online: the live bank served the old epoch")
    if not (int(r3.topk.indices[0]) != top
            or float(r3.topk.scores[0]) > float(r2.topk.scores[0])):
        raise AssertionError("online: the bank's winners did not move")
    k2 = fused_serve.launches - k2_before
    say(card, f"online: nudge_and_save on {name} (dismissed doc {dd[0]}, "
              f"word {dw[0]}) in {nudge_s:.3f} s: epoch "
              f"{m0.meta.get('model_epoch', 0)} -> {m1.meta['model_epoch']}, "
              f"pair score {float(p(th0, ph0, dd, dw)[0]):.6g} -> "
              f"{float(p(res.theta, res.phi_wk, dd, dw)[0]):.6g}; the "
              f"window's {len(win_card)} scores equal to the CPU nudge's "
              f"within rtol {2 * SVI_RTOL}; its {int(other.sum())} pairs of "
              f"another doc and word moved by {np.abs(rel - 1).max():.4f} at "
              f"most, {np.median(np.abs(rel - 1)):.2e} median; the live "
              f"bank re-scored "
              f"at epoch {bank.epoch(name)} (was {e0}), uncached; K2 "
              f"launches {k2}")
    return k2


def phase_lifecycle(card: str, root: pathlib.Path, table) -> tuple:
    """Phase 13 (b) to (f): the lifecycle on the card. Returns (the
    fleet week's K1 launches, the phase's K1 launches, its K2
    launches)."""
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as pool:
        # The kill -9 drill's supervisor processes run beside (b)-(d).
        drill = pool.submit(drill_process, root / "drill", "cuda")
        k1_week, k1, k2 = phase_fleet(card, root)
        t1 = time.perf_counter()
        k1_d, k2_d = phase_daily(card, root)
        with bounded("drill join", "the kill -9 drill's supervisors") \
                as lim:
            drilled = drill.result(timeout=lim)
    check_drill(card, root, *drilled)
    t2 = time.perf_counter()
    k1_c, k2_c = phase_campaign(card, root)
    t3 = time.perf_counter()
    k2_o = phase_online(card, root, table)
    t4 = time.perf_counter()
    say(card, f"phase 13 walls: fleet {t1 - t0:.1f} s, daily and drill "
              f"{t2 - t1:.1f} s, campaign {t3 - t2:.1f} s, online "
              f"{t4 - t3:.1f} s")
    return k1_week, k1 + k1_d + k1_c, k2 + k2_d + k2_c + k2_o


# -- phase 14 ---------------------------------------------------------------

# The analyst side at the reference's demo defaults (onix/cli.py `demo`:
# 20,000 events a datatype, the default LDA settings).
DEMO_EVENTS = 20_000
UI_PAGES = ("/", "/flow/suspicious.html", "/dns/suspicious.html",
            "/proxy/suspicious.html", "/onix.js", "/onix.css")
RUN_KEYS = ("n_events", "n_docs", "n_vocab", "n_tokens", "engine",
            "config_hash", "seed", "wall_seconds", "events_per_sec",
            "ll_series")


def http_raw(port: int, method: str, path: str, body: bytes | None = None,
             headers: dict | None = None):
    """One request on a fresh connection: (status, headers, body)."""
    import http.client
    with bounded("HTTP request", f"{method} {path}") as lim:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=lim)
        try:
            conn.request(method, path, body=body, headers=headers or {})
            r = conn.getresponse()
            return r.status, dict(r.getheaders()), r.read()
        finally:
            conn.close()


def port_cli(card: str, args: list) -> float:
    """`python -m onix_torch.cli <args>` in a child process, as a user
    runs it; raises unless it exits 0. Returns its wall seconds."""
    t0 = time.perf_counter()
    with bounded("analyst CLI", f"python -m onix_torch.cli {args[0]}") \
            as lim:
        proc = subprocess.run([sys.executable, "-m", "onix_torch.cli",
                               *args], cwd=HERE, capture_output=True,
                              text=True, timeout=lim)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"onix_torch.cli {args[0]} exited "
                             f"{proc.returncode}: {proc.stderr[-2000:]}")
    say(card, f"analyst: python -m onix_torch.cli {' '.join(args[:6])} ...: "
              f"rc 0 in {wall:.2f} s; {proc.stdout.strip()[-160:]}")
    return wall


def demo_k1_want(cfg, what: str) -> int:
    """K1's calls that the three demo days' manifests imply: one a block
    step, sweeps x blocks of the day's tokens. Each manifest's own
    count must say the same."""
    from onix_torch.store import results_path
    want = 0
    for t in ("flow", "dns", "proxy"):
        man = json.loads(results_path(cfg.store.results_dir, t, "2016-07-08")
                         .with_suffix(".manifest.json").read_text())
        steps = cfg.lda.n_sweeps * math.ceil(man["n_tokens"]
                                             / cfg.lda.block_size)
        check_launches(f"{what} {t} manifest",
                       man["kernel_launches"]["sample_count"], steps)
        want += steps
    return want


def check_oa_day(cfg, datatype: str, n_events: int) -> dict:
    """The OA files of the demo day of `datatype`; returns summary.json."""
    from onix_torch.oa.engine import oa_dir
    day = oa_dir(cfg, datatype, "2016-07-08")
    for name in ("suspicious.csv", "suspicious.json", "summary.json",
                 "graph.json", "storyboard.json", "geo.json", "ingest.json"):
        if not (day / name).is_file():
            raise AssertionError(f"demo: {datatype} lacks OA file {name}")
    dates = json.loads((day.parent / "dates.json").read_text())
    if dates != ["2016-07-08"]:
        raise AssertionError(f"demo: {datatype} dates.json is {dates}")
    summary = json.loads((day / "summary.json").read_text())
    run = summary.get("run", {})
    nulls = [k for k in RUN_KEYS if run.get(k) is None]
    if summary["n_results"] <= 0 or run.get("n_events") != n_events \
            or nulls:
        raise AssertionError(f"demo: {datatype} summary.json: n_results "
                             f"{summary['n_results']}, run.n_events "
                             f"{run.get('n_events')}, null keys {nulls}")
    return summary


def notebook_stack() -> tuple:
    """Whether the installed Jupyter stack renders (nbformat, nbconvert)
    and executes (those and nbclient, ipykernel) a hosted notebook."""
    import importlib.util
    have = {m: importlib.util.find_spec(m) is not None
            for m in ("nbformat", "nbconvert", "nbclient", "ipykernel")}
    render = have["nbformat"] and have["nbconvert"]
    return render, render and have["nbclient"] and have["ipykernel"]


def phase_demo(card: str, root: pathlib.Path):
    """Phase 14 (a) and (b): setup twice through the command line, then
    `run_demo` at the reference's defaults on the card. Returns (its
    config, its K1 launches, its -s flags)."""
    import torch

    from onix_torch.config import load_config
    from onix_torch.models import sample_count
    from onix_torch.oa import engine
    from onix_torch.oa.notebooks import code_cells
    from onix_torch.pipelines import run
    from onix_torch.setup_cmd import run_demo
    overrides = [f"store.root={root}", "serving.save_fitted=true"]
    flags = [a for o in overrides for a in ("-s", o)]
    for _ in range(2):
        port_cli(card, ["setup", "--device", "cuda", *flags])
    cfg = load_config(None, overrides)
    for t in ("flow", "dns", "proxy"):
        if not (root / t).is_dir():
            raise AssertionError(f"setup: no {t} directory")
    if not (root / "onix.config.json").is_file():
        raise AssertionError("setup: the config was not archived")
    for t in ("flow", "dns", "proxy"):
        nb = (pathlib.Path(cfg.oa.data_dir) / "notebooks"
              / f"{t}_threat_investigation.ipynb")
        src = "\n".join(code_cells(nb))
        if "from onix_torch." not in src or "from onix." in src:
            raise AssertionError(f"setup: {nb.name} does not import the "
                                 "port")
    torch.cuda.synchronize()
    sample_count.launches = 0
    t0 = time.perf_counter()
    with Calls(run, "run_scoring") as score, Calls(engine, "run_oa") as oa:
        rc = run_demo(cfg, n_events=DEMO_EVENTS, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"run_demo returned {rc}")
    k1 = sample_count.launches
    check_launches("demo K1", k1, demo_k1_want(cfg, "demo"))
    for i, t in enumerate(("flow", "dns", "proxy")):
        summary = check_oa_day(cfg, t, DEMO_EVENTS)
        run_ = summary["run"]
        say(card, f"demo: {t}: {run_['n_events']} events, D={run_['n_docs']}"
                  f" V={run_['n_vocab']} N={run_['n_tokens']}, "
                  f"{summary['n_results']} results; score wall "
                  f"{score.walls[i]:.3f} s (manifest {run_['wall_seconds']}"
                  f" s), run_oa wall {oa.walls[i]:.3f} s")
    say(card, f"demo: run_demo({DEMO_EVENTS}) on the card in {wall:.2f} s, "
              f"K1 launches {k1} = the manifests' block steps")
    return cfg, k1, flags


def phase_dashboards(card: str, cfg, server, port: int) -> None:
    """Phase 14 (c) up to /score: the UI, /data/, HEAD, traversal, the
    notebook routes and a kernel session; no bank is built."""
    from onix_torch.oa.engine import oa_dir
    from onix_torch.oa.notebooks import code_cells
    from onix_torch.oa.serve import UI_ROOT
    for page in UI_PAGES:
        status, _, body = http_raw(port, "GET", page)
        rel = "index.html" if page == "/" else page.lstrip("/")
        if status != 200 or body != (UI_ROOT / rel).read_bytes():
            raise AssertionError(f"dashboards: GET {page} answered {status}"
                                 " or not the UI file")
    for t in ("flow", "dns", "proxy"):
        day = oa_dir(cfg, t, "2016-07-08")
        for rel, path in ((f"/data/{t}/dates.json", day.parent / "dates.json"),
                          (f"/data/{t}/20160708/suspicious.json",
                           day / "suspicious.json")):
            status, _, body = http_raw(port, "GET", rel)
            if status != 200 or body != path.read_bytes():
                raise AssertionError(f"dashboards: GET {rel} answered "
                                     f"{status} or not the file on disk")
    status, headers, body = http_raw(port, "HEAD", "/flow/suspicious.html")
    size = (UI_ROOT / "flow" / "suspicious.html").stat().st_size
    if status != 200 or int(headers["Content-Length"]) != size or body:
        raise AssertionError(f"dashboards: HEAD answered {status}")
    for bad in ("/data/../../etc/passwd", "/../pyproject.toml"):
        status, _, _ = http_raw(port, "GET", bad)
        if status not in (403, 404):
            raise AssertionError(f"dashboards: GET {bad} answered {status}")
    nb_path = (pathlib.Path(cfg.oa.data_dir) / "notebooks"
               / "flow_threat_investigation.ipynb")
    status, _, body = http_raw(port, "GET", "/notebooks/flow.json")
    if status != 200 or json.loads(body) != json.loads(nb_path.read_text()):
        raise AssertionError(f"notebooks: GET flow.json answered {status}")
    render, execute = notebook_stack()
    status, _, body = http_raw(port, "GET", "/notebooks/flow.html")
    if (status, render) not in ((200, True), (501, False)) or (
            status == 501 and b"pip install nbconvert nbclient" not in body):
        raise AssertionError(f"notebooks: GET flow.html answered {status} "
                             f"with the stack's renderer present: {render}")
    run_status, _, body = http_raw(
        port, "POST", "/notebooks/run",
        json.dumps({"datatype": "flow", "date": "2016-07-08"}).encode(),
        {"Content-Type": "application/json"})
    if (run_status, execute) not in ((200, True), (501, False)) or (
            run_status == 501
            and b"pip install nbconvert nbclient" not in body):
        raise AssertionError(f"notebooks: POST /notebooks/run answered "
                             f"{run_status} with the stack present: "
                             f"{execute}")
    say(card, f"notebooks: /notebooks/flow.html answered {status}, "
              f"POST /notebooks/run {run_status} ("
              + ("the Jupyter stack is installed" if execute else
                 "no Jupyter stack here: the reference's 501 guidance")
              + ")")
    session, _ = http_json(port, "POST", "/notebooks/kernel",
                           {"action": "start", "date": "2016-07-08"})
    sid = session["session"]
    rows = sum(1 for _ in (oa_dir(cfg, "flow", "2016-07-08")
                           / "suspicious.csv").open()) - 1
    t0 = time.perf_counter()
    out, _ = http_json(port, "POST", "/notebooks/kernel/exec",
                       {"session": sid, "code": code_cells(nb_path)[0]})
    cell_s = time.perf_counter() - t0
    probe, _ = http_json(port, "POST", "/notebooks/kernel/exec", {
        "session": sid,
        "code": "import sys\n(len(results), 'torch' in sys.modules)"})
    stopped, _ = http_json(port, "POST", "/notebooks/kernel",
                           {"action": "stop", "session": sid})
    if not (out["ok"] and probe["ok"]
            and probe["result"] == f"({rows}, False)" and stopped["ok"]):
        raise AssertionError(f"kernel: load cell {out}, probe {probe}")
    say(card, f"kernel: the flow template's load cell read {rows} rows in "
              f"{cell_s:.2f} s in a kernel session without torch; "
              f"{out['stdout'].strip()}")
    if server.peek_bank_service() is not None:
        raise AssertionError("dashboards: a bank was built before /score")


def phase_analyst(card: str, root: pathlib.Path):
    """Phase 14: the analyst side on the card. (a) setup twice, (b) the
    demo, (c) the served dashboards and K2 through /score, (d) label ->
    /feedback -> re-score -> oa, (e) oa at phase 5's size, (f) the demo
    on the sessions generator. Returns (K1 launches, K2 launches)."""
    import pandas as pd
    import torch

    from onix_torch import cli
    from onix_torch.checkpoint import load_model
    from onix_torch.config import load_config
    from onix_torch.feedback.filter import filter_from_csv
    from onix_torch.models import fused_serve, sample_count
    from onix_torch.oa.engine import oa_dir
    from onix_torch.oa.serve import serve_background
    from onix_torch.setup_cmd import run_demo
    from onix_torch.store import (Store, feedback_path, model_name,
                                  results_path)
    t_phase = time.perf_counter()
    cfg, k1, flags = phase_demo(card, root / "demo")
    date, tenant = "2016-07-08", model_name("flow", "2016-07-08")
    table = Store(cfg.store.root).read("flow", date)
    d_all, w_all, hour, bundle = day_requests(table, cfg.pipeline.dupfactor)
    windows = [("am", d_all[hour < 12], w_all[hour < 12]),
               ("pm", d_all[hour >= 12], w_all[hour >= 12])]
    tol, m = cfg.pipeline.tol, cfg.pipeline.max_results
    dev = "cuda"

    def body(reqs):
        return {"requests": [{"tenant": tenant, "window": win,
                              "doc_ids": d.tolist(), "word_ids": w.tolist()}
                             for win, d, w in reqs]}

    torch.cuda.synchronize()
    fused_serve.launches = 0
    t0 = time.perf_counter()
    server, port = serve_background(cfg, device="cuda")
    try:
        phase_dashboards(card, cfg, server, port)
        say(card, f"dashboards: pages, /data/, HEAD, traversal, notebooks "
                  f"and a kernel session in {time.perf_counter() - t0:.2f} s"
                  ", no bank built")
        saved = load_model(cfg.serving.models_dir, tenant)
        th = torch.from_numpy(saved.arrays["theta"]).to(dev)
        ph = torch.from_numpy(saved.arrays["phi_wk"]).to(dev)

        def want(d, w, filt=None):
            return fused_serve.fused_call_plain(
                (th, ph, torch.from_numpy(d).to(dev),
                 torch.from_numpy(w).to(dev)),
                torch.ones(len(d), device=dev), None, None, filt, tol,
                mode="dot", max_results=m)

        out, wall = http_json(port, "POST", "/score", body(windows))
        service = server.peek_bank_service()
        if fused_serve.launches != 1 or service.bank.dispatches != 1:
            raise AssertionError(f"/score: K2 launched "
                                 f"{fused_serve.launches} times for "
                                 f"{service.bank.dispatches} waves, want 1")
        for (win, d, w), res in zip(windows, out["results"]):
            check_winners(res, want(d, w), f"demo {win}")
        say(card, f"dashboards: /score of the demo's flow tenant, "
                  f"{len(d_all)} events in 2 windows: one K2 launch, winners "
                  f"equal the plain version's, wall {wall:.3f} s")

        # (d) label three rows by rank, then one more benign pair by POST.
        sus = pd.read_csv(oa_dir(cfg, "flow", date) / "suspicious.csv")
        labelled = [(str(r.ip), str(r.word)) for r in sus.iloc[:3]
                    .itertuples()]
        port_cli(card, ["label", date, "flow", "1", "2", "3", "--label", "3",
                        "--device", "cuda", *flags])
        am = out["results"][0]
        _, d_am, w_am = windows[0]
        for i in am["indices"]:
            pair = (int(d_am[i]), int(w_am[i]))
            named = (str(bundle.doc_keys[pair[0]]),
                     str(bundle.vocab.words[pair[1]]))
            if named not in labelled:
                break
        labelled.append(named)
        epoch0 = service.bank.epoch(tenant)
        fb, _ = http_json(port, "POST", "/feedback", {
            "datatype": "flow", "date": date, "rows": [{
                "ip": named[0], "word": named[1], "label": 3,
                "doc_id": pair[0], "word_id": pair[1]}]})
        if not (fb["ok"] and fb["model_epoch"] > epoch0):
            raise AssertionError(f"/feedback did not move the epoch: {fb}")
        again, _ = http_json(port, "POST", "/score", body(windows[:1]))
        res = again["results"][0]
        alive = {(int(d_am[i]), int(w_am[i])) for i in res["indices"]
                 if i >= 0}
        filt = filter_from_csv(feedback_path(cfg.store.feedback_dir, "flow",
                                             date),
                               cfg.feedback.boost_scale).tables(device=dev)
        if res["cached"] or pair in alive:
            raise AssertionError("/feedback: the benign pair was served")
        check_winners(res, want(d_am, w_am, filt), "am after feedback")
        say(card, f"feedback: label ranks 1-3 by the CLI, one pair by POST: "
                  f"epoch {epoch0} -> {fb['model_epoch']}, the pair gone "
                  f"from the next /score, winners equal the plain version's"
                  f" under the filter")
    finally:
        server.shutdown()
        server.server_close()
    torch.cuda.synchronize()
    k2 = fused_serve.launches
    if not (k2 == service.bank.dispatches == 2):
        raise AssertionError(f"dashboards: K2 launched {k2} times for "
                             f"{service.bank.dispatches} waves, want 2")

    # Re-score the day: the four benign rows enter the corpus x dupfactor.
    res_csv = results_path(cfg.store.results_dir, "flow", date)
    before = pd.read_csv(res_csv)
    sample_count.launches = 0
    t0 = time.perf_counter()
    rc = cli.main(["score", date, "flow", "--device", "cuda", *flags])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"re-score exited {rc}")
    man = json.loads(res_csv.with_suffix(".manifest.json").read_text())
    if man["n_feedback_tokens"] != cfg.pipeline.dupfactor * 4:
        raise AssertionError(f"re-score: n_feedback_tokens "
                             f"{man['n_feedback_tokens']}, want "
                             f"{cfg.pipeline.dupfactor} x 4")
    steps = cfg.lda.n_sweeps * math.ceil(man["n_tokens"]
                                         / cfg.lda.block_size)
    check_launches("re-score K1", sample_count.launches, steps)
    k1 += sample_count.launches
    after = pd.read_csv(res_csv)

    def worst(df, ip, word):
        hit = df[(df["ip"].astype(str) == ip)
                 & (df["word"].astype(str) == word)]["score"]
        return float(hit.min()) if len(hit) else None
    higher = left = seen = 0
    for ip, word in labelled:
        s0, s1 = worst(before, ip, word), worst(after, ip, word)
        if s0 is None:
            continue
        seen += 1
        left += s1 is None
        higher += s1 is not None and s1 > s0
    if not higher + left:
        raise AssertionError("re-score: no labelled pair scored higher or "
                             "left the results")
    say(card, f"re-score: {man['n_feedback_tokens']} feedback tokens, K1 "
              f"launches {sample_count.launches}, wall {wall:.2f} s; of the "
              f"{seen} labelled pairs in the results, {higher} scored "
              f"higher and {left} left them")
    dates = oa_dir(cfg, "flow", date).parent / "dates.json"
    dates0 = dates.read_bytes()
    if cli.main(["oa", date, "flow", "--device", "cuda", *flags]) != 0 \
            or dates.read_bytes() != dates0:
        raise AssertionError("oa after the re-score failed or moved "
                             "dates.json")

    # (e) oa on phase 5's day, at pipeline.max_results.
    day_root = root / "day"
    t0 = time.perf_counter()
    if cli.main(["oa", date, "flow", "-s", f"store.root={day_root}"]) != 0:
        raise AssertionError("oa on phase 5's day failed")
    wall = time.perf_counter() - t0
    day_cfg = load_config(None, [f"store.root={day_root}"])
    n_rows = len(pd.read_csv(oa_dir(day_cfg, "flow", date)
                             / "suspicious.csv"))
    if n_rows != len(pd.read_csv(results_path(day_cfg.store.results_dir,
                                              "flow", date))):
        raise AssertionError("oa on phase 5's day dropped rows")
    say(card, f"oa: phase 5's day (10^6 events), {n_rows} results "
              f"(pipeline.max_results {day_cfg.pipeline.max_results}): "
              f"run_oa wall {wall:.3f} s")

    # (f) the demo on the sessions generator, in a store of its own.
    s_cfg = load_config(None, [f"store.root={root / 'demo_sessions'}"])
    sample_count.launches = 0
    t0 = time.perf_counter()
    if run_demo(s_cfg, n_events=DEMO_EVENTS, generator="sessions",
                device="cuda") != 0:
        raise AssertionError("the sessions demo failed")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_launches("sessions demo K1", sample_count.launches,
                   demo_k1_want(s_cfg, "sessions demo"))
    k1 += sample_count.launches
    for t in ("flow", "dns", "proxy"):
        check_oa_day(s_cfg, t, DEMO_EVENTS)
    marker = (root / "demo_sessions" / ".demo_generator").read_text()
    try:
        run_demo(s_cfg, n_events=DEMO_EVENTS, generator="mixture",
                 device="cuda")
    except ValueError as e:
        if "already holds a demo day" not in str(e):
            raise
    else:
        raise AssertionError("a mixture demo over a sessions store ran")
    if marker != "sessions\n":
        raise AssertionError(f"sessions demo marker reads {marker!r}")
    say(card, f"demo --generator sessions: {wall:.2f} s, K1 launches "
              f"{sample_count.launches}; marker 'sessions'; a mixture "
              f"re-run refused")
    say(card, f"phase 14 wall {time.perf_counter() - t_phase:.1f} s")
    return k1, k2


# -- phase 15 ---------------------------------------------------------------

# (b): the dp x mp mesh laid onto the one card, and the async arm's dp.
SHARD_MESH = (4, 2)
SHARD_ASYNC_DP = 4
# (c): the drill's SIGKILL lands on worker 1 once it reports this sweep;
# a lease with room for a worker's CUDA start-up.
FABRIC_KILL = {"host": 1, "after_sweep": 20}
FABRIC_KW = dict(n_hosts=2, local_devices=1, lease_s=15.0, beat_s=0.5,
                 collective_deadline_s=120.0,
                 device="cuda",
                 worker_env={0: {"CUDA_VISIBLE_DEVICES": "0"},
                             1: {"CUDA_VISIBLE_DEVICES": "0"}})
# The reference's bar for a sharded fit's topics against one device's
# (tests/test_sharded_gibbs.py:95-106).
SHARD_SIMILARITY_BAR = 0.9


class OneCardMesh:
    """While active, `make_mesh` lays a mesh that names no `devices` onto
    the one card (every position cuda:0), so the entry points' own
    `make_mesh(dp, mp)` runs a dp x mp mesh here."""

    def __enter__(self):
        from onix_torch.parallel import mesh
        self.mod, self.real = mesh, mesh.make_mesh

        def make_mesh(dp=None, mp=1, devices=None, device="cuda"):
            if devices is None and dp is not None:
                devices = ["cuda:0"] * (dp * mp)
            return self.real(dp, mp, devices=devices, device=device)
        mesh.make_mesh = make_mesh
        return self

    def __exit__(self, *exc):
        self.mod.make_mesh = self.real
        return False


def card_mesh(dp: int, mp: int = 1):
    from onix_torch.parallel.mesh import make_mesh
    return make_mesh(dp, mp, devices=["cuda:0"] * (dp * mp))


def topic_similarity(phi_a, phi_b) -> float:
    """Mean cosine similarity of two [V, K] topic tables' columns after
    Hungarian matching (the reference's `_topic_alignment_similarity`)."""
    import numpy as np
    from scipy.optimize import linear_sum_assignment
    a = phi_a.T / np.linalg.norm(phi_a.T, axis=1, keepdims=True)
    b = phi_b.T / np.linalg.norm(phi_b.T, axis=1, keepdims=True)
    sim = a @ b.T
    r, c = linear_sum_assignment(-sim)
    return float(sim[r, c].mean())


def check_shard_counts(what: str, state, sc, doc_lengths,
                       n_tokens: int) -> str:
    """The count invariants of a shard-arm state on the card: every
    chain's n_k and n_wk sum to N, nothing is negative, and each local
    document's n_dk row sums to its length."""
    import numpy as np
    import torch
    n_k, n_wk, n_dk = state.n_k, state.n_wk, state.n_dk
    rows = torch.as_tensor(np.where(sc.doc_map >= 0,
                                    doc_lengths[np.maximum(sc.doc_map, 0)],
                                    0), device=n_dk.device)
    ok = ((n_k.sum(dim=1) == n_tokens).all()
          and (n_wk.sum(dim=(0, 2, 3)) == n_tokens).all()
          and int(n_dk.min()) >= 0 and int(n_wk.min()) >= 0
          and (n_dk.sum(dim=3) == rows[:, None]).all())
    if not ok:
        raise AssertionError(f"{what}: a count invariant is broken")
    return (f"n_k and n_wk sum to {n_tokens} in each of {n_k.shape[0]} "
            "chain(s), counts >= 0, n_dk rows = doc lengths")


def phase_shard_step(card: str, corpus) -> dict:
    """(a) K1's lane form at the dp 4 x mp 2 shard lanes of the day: one
    call steps the 8 positions' first blocks, each lane its own ids
    (local chunk rows), against its own views of n_dk[p], n_wk chunk m
    and n_k, v_eta from the global V. From one snapshot it must equal
    its plain version exactly. Times the call (CUDA events, median of
    30) and the plain version, with the bound summed over the lanes."""
    import itertools

    import torch

    from onix_torch.config import LDAConfig
    from onix_torch.models import sample_count as sc
    from onix_torch.parallel.sharded_gibbs import ShardedGibbsLDA
    cfg = LDAConfig()
    model = ShardedGibbsLDA(cfg, corpus.n_vocab, mesh=card_mesh(*SHARD_MESH))
    layout = model.prepare(corpus)
    (docs, words, mask), = model.device_corpus(layout)
    state = model.init_state(layout)
    z = state.z.view(-1, *state.z.shape[3:])
    k, b = cfg.n_topics, docs.shape[-1]
    kw = dict(alpha=cfg.alpha, eta=cfg.eta, v_eta=corpus.n_vocab * cfg.eta,
              use_gumbel=True)
    noise = model.default_noise()
    snap = (*model.lane_views(state), z)

    def fresh():
        return [x.clone() for x in snap]

    def step(st, fn=sc.gibbs_block_step_, g=None):
        fn(st[0], st[1], st[2], st[3][:, 0], g, docs[:, 0], words[:, 0],
           mask[:, 0], **kw)
    (draw,) = noise.block(b, k, True)
    want = fresh()
    step(want, sc.gibbs_block_step_plain, draw)
    got = fresh()
    before = sc.launches
    step(got, g=draw)
    torch.cuda.synchronize()
    if sc.launches - before != 1:
        raise AssertionError(f"K1 shard lanes: {sc.launches - before} "
                             "calls, not 1")
    for name, a, e in zip(("n_dk", "n_wk", "n_k", "z"), got, want):
        if not torch.equal(a, e):
            raise AssertionError(f"K1 shard lanes: {name} differs from the "
                                 f"plain step at {int((a != e).sum())} "
                                 "places")
    err = max(float((a.double() - e.double()).abs().max())
              for a, e in zip(got, want))
    draws = itertools.cycle([noise.block(b, k, True)[0]
                             for _ in range(4)])
    work, plain_work = fresh(), fresh()
    ms = event_ms(lambda: step(work, g=next(draws)))
    plain_ms = event_ms(lambda: step(plain_work, sc.gibbs_block_step_plain,
                                     next(draws)), reps=10)
    lanes = z.shape[0]
    nbytes = ops = 0
    for i in range(lanes):
        _, _, nb_i, ops_i = step_bound(docs[i, 0], words[i, 0], z[i, 0],
                                       want[3][i, 0], mask[i, 0], k, True)
        nbytes += nb_i
        ops += ops_i
    bound_ms, bound_by = bound_of(nbytes, ops)
    roofline_check(card, "K1 shard lanes", nbytes, ms)
    real = int((mask[:, 0] > 0).sum())
    say(card, f"K1 shard lanes dp {SHARD_MESH[0]} x mp {SHARD_MESH[1]} on "
              f"one card: {lanes} lanes x B={b}, K={k}, Vc="
              f"{layout.n_vocab_local}, Dl={layout.n_docs_local}, {real} "
              f"real tokens, Gumbel: one call, z, n_dk, n_wk, n_k equal to "
              f"plain; call {ms:.5f} ms, plain {plain_ms:.5f} ms (CUDA "
              f"events, median); bound {bound_ms:.5f} ms by {bound_by} "
              f"({nbytes} B, {ops} ops)")
    return {"mesh": list(SHARD_MESH), "lanes": lanes, "B": b, "K": k,
            "Vc": layout.n_vocab_local, "Dl": layout.n_docs_local, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "max_abs_err": err, "library_ms": None}


def shard_fit(card: str, corpus, mesh, tag: str, **cfg_kw) -> dict:
    """One direct fit of the day's corpus on `mesh` at the default
    config (with `cfg_kw`): K1 launches = sweeps x the layout's blocks
    (one call a block for the mesh's one device group)."""
    import torch

    from onix_torch.config import LDAConfig
    from onix_torch.models import sample_count
    from onix_torch.parallel.sharded_gibbs import ShardedGibbsLDA
    cfg = LDAConfig(**cfg_kw)
    model = ShardedGibbsLDA(cfg, corpus.n_vocab, mesh=mesh)
    torch.cuda.synchronize()
    sample_count.launches = 0
    t0 = time.perf_counter()
    fit = model.fit(corpus)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    nb = fit["sharded_corpus"].doc_blocks.shape[2]
    check_launches(f"{tag}: K1", sample_count.launches, cfg.n_sweeps * nb)
    lls = [ll for _, ll in fit["ll_history"]]
    say(card, f"{tag}: mesh {model.mesh.shape}, {nb} blocks of "
              f"{fit['sharded_corpus'].doc_blocks.shape[3]} a position, K1 "
              f"launches {sample_count.launches}; fit {wall:.2f} s; ll "
              f"{lls[0]:.5f} -> {lls[-1]:.5f}")
    fit["k1"] = sample_count.launches
    return fit


def phase_shard_fit(card: str, root: pathlib.Path, table, planted, corpus,
                    phi_1x1) -> int:
    """(b) `onix_torch score --engine sharded -s mesh.dp=4 -s mesh.mp=2`
    on the phase-5 day with its mesh on the one card: K1 launches =
    sweeps x blocks, the count invariants, recall >= the bar and topics
    similar to phase 5's one-device fit; then async τ=1 at dp 4, its
    final ll within LL_PARITY_BAND of sync at dp 4; then ONIX_DP1_FAST=0
    at 1x1, bit-identical to the fast path. Returns the score run's K1
    launches."""
    import numpy as np
    import pandas as pd
    import torch

    from onix_torch import cli
    from onix_torch.config import LDAConfig
    from onix_torch.models import lda_gibbs, sample_count
    from onix_torch.parallel.sharded_gibbs import ShardedGibbsLDA
    from onix_torch.store import Store
    dp, mp = SHARD_MESH
    tag = f"sharded day dp {dp} x mp {mp}"
    day = root / "shard_day"
    Store(day).write("flow", "2016-07-08", table)
    torch.cuda.synchronize()
    sample_count.launches = 0
    t0 = time.perf_counter()
    with OneCardMesh(), FitStates(ShardedGibbsLDA) as fits:
        rc = cli.main(["score", "2016-07-08", "flow", "-s",
                       f"store.root={day}", "--engine", "sharded", "-s",
                       f"mesh.dp={dp}", "-s", f"mesh.mp={mp}"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1 = sample_count.launches
    if rc != 0:
        raise AssertionError(f"{tag}: onix_torch score exited {rc}")
    (fit, corp), = fits.seen
    layout = fit["sharded_corpus"]
    nb = layout.doc_blocks.shape[2]
    n_sweeps = LDAConfig().n_sweeps
    check_launches(f"{tag}: K1", k1, n_sweeps * nb)
    got = day_outputs(day / "results")
    check_launches(f"{tag}: K1 (manifest)",
                   got["manifest"]["kernel_launches"]["sample_count"],
                   n_sweeps * nb)
    inv = check_shard_counts(tag, fit["state"], layout, corp.doc_lengths(),
                             corp.n_tokens)
    res = pd.read_csv(day / "results" / "20160708" / "flow_results.csv")
    recall = len(set(res["event_idx"]) & set(planted.tolist())) / len(
        planted)
    sim = topic_similarity(phi_1x1, fit["phi_wk"])
    lls = [ll for _, ll in fit["ll_history"]]
    say(card, f"{tag}: onix_torch score 2016-07-08 flow --engine sharded "
              f"-s mesh.dp={dp} -s mesh.mp={mp}: {dp * mp} positions on "
              f"cuda:0, {nb} blocks of {layout.doc_blocks.shape[3]} each, "
              f"K1 launches {k1} = {n_sweeps} x {nb}; {inv}; wall "
              f"{wall:.2f} s, stages {json.dumps(stage_walls(got))}; "
              f"recall {recall:.4f} (bar {RECALL_BAR}); topic similarity "
              f"to phase 5's one-device fit {sim:.4f} (bar "
              f"{SHARD_SIMILARITY_BAR}); ll {lls[0]:.5f} -> {lls[-1]:.5f}")
    if recall < RECALL_BAR or sim <= SHARD_SIMILARITY_BAR:
        raise AssertionError(f"{tag}: recall {recall}, similarity {sim}")

    sync = shard_fit(card, corpus, card_mesh(SHARD_ASYNC_DP),
                     f"sync dp {SHARD_ASYNC_DP}")
    asy = shard_fit(card, corpus, card_mesh(SHARD_ASYNC_DP),
                    f"async τ=1 dp {SHARD_ASYNC_DP}", merge_form="async",
                    merge_staleness=1)
    ll_s, ll_a = sync["ll_history"][-1][1], asy["ll_history"][-1][1]
    gap = abs(ll_a - ll_s) / abs(ll_s)
    say(card, f"async τ=1 dp {SHARD_ASYNC_DP}: final ll {ll_a:.5f} against "
              f"sync {ll_s:.5f}, {gap:.5f} relative (band "
              f"{lda_gibbs.LL_PARITY_BAND})")
    if gap > lda_gibbs.LL_PARITY_BAND:
        raise AssertionError(f"async τ=1 out of the ll band: {gap}")
    del sync, asy

    fast = shard_fit(card, corpus, card_mesh(1), "1x1 fast path")
    os.environ["ONIX_DP1_FAST"] = "0"
    try:
        arm = shard_fit(card, corpus, card_mesh(1),
                        "1x1 shard arm (ONIX_DP1_FAST=0)")
    finally:
        del os.environ["ONIX_DP1_FAST"]
    same = (torch.equal(arm["state"].z[0, 0], fast["state"].z)
            and np.array_equal(arm["theta"], fast["theta"])
            and np.array_equal(arm["phi_wk"], fast["phi_wk"]))
    say(card, f"ONIX_DP1_FAST=0 at 1x1: z, theta and phi_wk "
              f"{'bit-identical to' if same else 'DIFFER from'} the fast "
              "path's")
    if not same:
        raise AssertionError("the 1x1 shard arm differs from the fast path")
    return k1


def phase_fabric(card: str, root: pathlib.Path, corpus) -> int:
    """(c) `hostfabric.run_fit` with 2 workers x 1 position, both on the
    card through worker_env CUDA_VISIBLE_DEVICES=0, sync: theta, phi_wk
    and z bit-identical to the in-process make_mesh(dp=2) fit on the
    card, each worker's K1 launches (from its result) sweeps x blocks;
    then the SIGKILL drill, resumed bit-identical. Both workers on one
    card take gloo (NCCL refuses one card twice in a communicator): the
    placement's backend and the manifest's say so. Returns the fabric
    runs' K1 launches (final generations) and that backend."""
    import numpy as np

    from onix_torch.config import LDAConfig
    from onix_torch.parallel import hostfabric
    from onix_torch.parallel.mesh import collective_backend
    env = FABRIC_KW["worker_env"]
    backend = collective_backend("cuda", [
        env[i]["CUDA_VISIBLE_DEVICES"] for i in range(FABRIC_KW["n_hosts"])])
    if backend != "gloo":
        raise AssertionError(f"the shared-card placement gives {backend}")
    ref = shard_fit(card, corpus, card_mesh(2), "in-process dp 2")
    # One call a block steps both positions in process; each worker
    # steps its one position in as many calls.
    want = ref["k1"]
    total = 0
    for label, kill in (("fabric", None), ("fabric drill", FABRIC_KILL)):
        t0 = time.perf_counter()
        lim = WAIT_LIMITS["fabric generation"]
        try:
            out = hostfabric.run_fit(corpus, LDAConfig(), root / label,
                                     kill_plan=kill, timeout_s=lim,
                                     **FABRIC_KW)
        except hostfabric.FabricError as e:
            if "timed out" not in str(e):
                raise
            raise StepTimeout(f"phase {PHASE['n']}, fabric generation: "
                              f"{label}'s workers did not finish within "
                              f"{lim:.0f} s") from e
        wall = time.perf_counter() - t0
        m = out["manifest"]
        key = f"phase {PHASE['n']}: fabric generation"
        WAIT_WALLS[key] = max([WAIT_WALLS.get(key, 0.0),
                               *m["walls"]["generations_s"]])
        same = (np.array_equal(out["theta"], ref["theta"])
                and np.array_equal(out["phi_wk"], ref["phi_wk"])
                and np.array_equal(out["arrays"]["z"],
                                   ref["state"].z.cpu().numpy()))
        say(card, f"{label}: 2 workers x 1 position on cuda:0 "
                  f"(CUDA_VISIBLE_DEVICES=0 each), {m['backend']} process "
                  f"group; wall {wall:.2f} s (generations "
                  f"{m['walls']['generations_s']}); deaths "
                  f"{[d['host'] for d in m['deaths']]}, restarts "
                  f"{m['restarts']}, resume sweeps {m['resume_sweeps']}; "
                  f"K1 launches a worker {m['k1_launches']}; theta, phi_wk "
                  f"and z {'bit-identical to' if same else 'DIFFER from'} "
                  "the in-process dp 2 fit's")
        if not same or m["backend"] != backend:
            raise AssertionError(f"{label}: differs from the in-process "
                                 f"fit, or ran {m['backend']}")
        if kill is None:
            if m["k1_launches"] != [want, want] or m["deaths"]:
                raise AssertionError(f"{label}: launches "
                                     f"{m['k1_launches']}, want {want} each")
        elif len(m["deaths"]) != 1 or m["restarts"] != 1 \
                or m["resume_sweeps"][1] < 0:
            raise AssertionError(f"{label}: deaths {m['deaths']}, resume "
                                 f"{m['resume_sweeps']}")
        total += sum(m["k1_launches"])
    return total, backend


def nccl_probe_child(out: str) -> None:
    """(e), in a child process: a one-rank NCCL process group on the
    card (`mesh.multihost_init`), then one int32 and one float64
    all-reduce through the engine's `all_reduce_` and the fabric's
    deadline wait; writes what it saw to `out` as JSON."""
    import socket

    import torch

    from onix_torch.parallel import hostfabric, mesh, sharded_gibbs
    t0 = time.perf_counter()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    deadline_s = FABRIC_KW["collective_deadline_s"]
    mesh.multihost_init(f"127.0.0.1:{port}", 1, 0, init_timeout_s=60,
                        device="cuda", backend="nccl",
                        collective_timeout_s=hostfabric.group_timeout_s(
                            deadline_s))
    init_s = time.perf_counter() - t0
    backend = torch.distributed.get_backend()
    hb = hostfabric.HeartbeatWriter(pathlib.Path(out + ".hb"), 0, 0.5)
    wait = hostfabric._wait_with_deadline(deadline_s, hb, backend)
    home = torch.device("cuda", 0)
    # A sum over one rank is its input: this shows the start, the
    # dtypes and the wait ran, not that anything was summed.
    ran = {}
    for dtype in (torch.int32, torch.float64):
        x = torch.arange(1, 4097, device=home).to(dtype)
        y = x.clone()
        sharded_gibbs.all_reduce_([y], home, wait)
        ran[str(dtype).split(".")[1]] = bool(torch.equal(x, y))
    mesh.multihost_shutdown()
    pathlib.Path(out).write_text(json.dumps({
        "backend": backend, "init_s": round(init_s, 3), "ran": ran,
        "wall_s": round(time.perf_counter() - t0, 3)}))


def start_nccl_probe(root: pathlib.Path) -> tuple:
    """Start (e)'s NCCL child beside (b)-(d): a process group in the
    smoke's own process would show phase 16's collective-free checks a
    c10d op."""
    out = root / "nccl_probe.json"
    proc = subprocess.Popen(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "chip_smoke.nccl_probe_child(sys.argv[1])", str(out)],
        cwd=str(HERE), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    return proc, out, time.perf_counter()


def finish_nccl_probe(proc, out: pathlib.Path, t0: float) -> dict:
    """Wait for (e)'s child and check it: an NCCL group, both
    all-reduces ran and returned their input."""
    try:
        with bounded("NCCL probe", "the one-rank NCCL group's child") \
                as lim:
            log, _ = proc.communicate(
                timeout=max(1.0, lim - (time.perf_counter() - t0)))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    if proc.returncode != 0:
        raise AssertionError(f"NCCL probe: the child exited "
                             f"{proc.returncode}:\n{log[-3000:]}")
    got = json.loads(out.read_text())
    if got["backend"] != "nccl" or not all(got["ran"].values()):
        raise AssertionError(f"NCCL probe: {got}")
    return got


def phase_shard_refusals(card: str, root: pathlib.Path) -> None:
    """(d) the refusals one card implies, asserted by message: a
    dp=2 mesh from the card's devices alone, and a fabric of two card
    workers that no worker_env places."""
    from onix_torch import cli
    from onix_torch.parallel.hostfabric import FabricError
    from onix_torch.pipelines.scale import run_scale
    cases = [
        ("score --engine sharded -s mesh.dp=2", "needs 2 devices, have 1",
         lambda: cli.main(["score", "2016-07-08", "flow", "-s",
                           f"store.root={root / 'day'}", "--engine",
                           "sharded", "-s", "mesh.dp=2"])),
        ("run_scale(fit_hosts=2)", "need 2 cards, this host has 1",
         lambda: run_scale(200_000, n_sweeps=1, fit_hosts=2,
                           device="cuda")),
    ]
    for what, msg, call in cases:
        try:
            call()
        except (ValueError, FabricError) as e:
            if msg not in str(e):
                raise AssertionError(f"{what}: refused with {e!r}, not "
                                     f"{msg!r}") from e
            say(card, f"refusal: {what} on one card: {e}")
            continue
        raise AssertionError(f"{what} ran on one card")


def phase_shards(card: str, root: pathlib.Path, table, planted,
                 phi_1x1, small) -> tuple:
    """Phase 15: (a)-(e); the fabric's fits run on the small day's
    corpus (`small`). Returns (K1's `shards` row, K1 launches)."""
    from onix_torch.pipelines.corpus_build import build_corpus
    from onix_torch.pipelines.words import flow_words
    t0 = time.perf_counter()
    corpus = build_corpus(flow_words(table)).corpus
    row = phase_shard_step(card, corpus)
    probe = start_nccl_probe(root)
    try:
        k1_score = phase_shard_fit(card, root, table, planted, corpus,
                                   phi_1x1)
        k1_fabric, backend = phase_fabric(
            card, root, build_corpus(flow_words(small)).corpus)
        phase_shard_refusals(card, root)
    except BaseException:
        probe[0].kill()
        probe[0].communicate()
        raise
    got = finish_nccl_probe(*probe)
    row.update(launches_mesh_day=k1_score, launches_fabric=k1_fabric)
    say(card, f"phase 15: process groups: the shared-card fabric's on "
              f"{backend} (its manifest, and the placement's backend); a "
              f"one-rank {got['backend']} group in a child process: "
              f"started in {got['init_s']:.2f} s, an int32 and a float64 "
              f"all-reduce through the deadline wait ran ({got['ran']}: "
              f"NCCL's start, its dtypes and the wait, not a sum), child "
              f"{got['wall_s']:.2f} s; wall "
              f"{time.perf_counter() - t0:.1f} s")
    return row, k1_score + k1_fabric


# -- phase 16 ---------------------------------------------------------------

# (a) the sharded bank at the harness's bench shape (BENCH_SPEC), its
# homes laid on the one card.
PLACEMENT_HOMES = (1, 2, 4)
# (b) requests of distinct harness tenants in one /score body.
PLACEMENT_SERVE_REQUESTS, PLACEMENT_SERVE_EVENTS = 8, 4096
# (c) the fleet refit at scripts/exp_fleet.py's widths (600 events a
# day, K 10, 8 sweeps, M 60, seed 3, 8 plants on day 1), cut from its 7
# days to 2 and from 200 tenants to 50; dp 1 against dp 2 and dp 4 on
# the one card.
PLACEMENT_FLEET = dict(days=2, tenants=50, n_events=600, n_sweeps=8,
                       n_topics=10, max_results=60, seed=3, plant=8)
PLACEMENT_FLEET_DP = (2, 4)
# (a) the staging check's trials, each behind its own spin.
STAGING_TRIALS = 3
# K1's lane form at a padded fleet class the week's rows do not cover:
# the 200-tenant 2-day fleet's 21-lane class (V 128) padded with a dead
# lane to 22 for dp 2 (lanes, B, V, D).
FLEET_DP_LANES = (22, 2048, 128, 256)


class OneCardDevices:
    """While active, `mesh.visible_devices` of a card names cuda:0 `n`
    times, so the entry points that take the visible cards (the
    harness's `spec.devices`, `onix serve`'s bank, `make_mesh(dp=None)`)
    place that many homes or positions on the one card."""

    def __init__(self, n: int):
        self.n = n

    def __enter__(self):
        import torch

        from onix_torch.parallel import mesh
        self.mod, self.real = mesh, mesh.visible_devices

        def visible_devices(device="cuda"):
            got = self.real(device)
            if got and got[0].type == "cuda":
                return [torch.device("cuda", 0)] * self.n
            return got
        mesh.visible_devices = visible_devices
        return self

    def __exit__(self, *exc):
        self.mod.visible_devices = self.real
        return False


def wave_counts() -> dict:
    from onix_torch.utils.obs import counters
    return {k: v for k, v in counters.snapshot("bank").items()
            if k.startswith("bank.wave.d")}


def same_winners(a, b) -> bool:
    """Two harness replays' winners, scores and indices, bit for bit."""
    import numpy as np
    return len(a["results"]) == len(b["results"]) and all(
        np.array_equal(np.asarray(x.topk.scores), np.asarray(y.topk.scores))
        and np.array_equal(np.asarray(x.topk.indices),
                           np.asarray(y.topk.indices))
        for x, y in zip(a["results"], b["results"]))


def sharded_wave_row(card: str, args, kw) -> dict:
    """K2 at a sharded bank wave's shape, on the wave's own inputs: equal
    to its plain version; its call and the plain version timed (CUDA
    events, median of 30), with the byte bound and the torch.topk
    yardstick of the other K2 rows."""
    import torch

    from onix_torch.models import fused_serve as fs
    theta, phi, slots, d, w, m, tol, filt = args
    case = dict(ops=(theta, phi, d, w), mask=m, mode="dot", slots=slots,
                max_results=kw["max_results"], tol=tol, filt=filt,
                shape=tuple(d.shape), row_len=kw["row_len"])
    cargs, opts = _k2_args(case)
    got = fs.fused_call(*cargs, **opts)
    want = fs.fused_call_plain(*cargs, **opts)
    torch.cuda.synchronize()
    if not (torch.equal(got.scores, want.scores)
            and torch.equal(got.indices, want.indices)):
        raise AssertionError("K2 at the sharded wave differs from its plain "
                             "version")
    fin = torch.isfinite(want.scores)
    err = float(torch.where(fin, (got.scores - want.scores).abs(),
                            torch.zeros_like(got.scores)).max())
    ms = event_ms(lambda: fs.fused_call(*cargs, **opts))
    plain_ms = event_ms(lambda: fs.fused_call_plain(*cargs, **opts))
    n_real = int((m > 0).sum())
    bound_ms, bound_by, nbytes, ops = k2_bound(case, n_real)
    roofline_check(card, "K2 sharded wave {}x{}".format(*case["shape"]),
                   nbytes, ms)
    r, n = case["shape"]
    mr = case["max_results"]
    screened = k2_screened(case)
    topk_ms = event_ms(lambda: torch.topk(screened, mr, dim=-1,
                                          largest=False, sorted=True))
    form = fs.kernel_form(r, n, mr, theta.shape[-1])
    say(card, f"K2 sharded wave {r}x{n} (M {mr}, {n_real} real events): "
              f"{form} form, equal to plain; call {ms:.5f} ms (CUDA events, "
              f"median of 30); bound {bound_ms:.5f} ms by {bound_by} "
              f"({nbytes} B, {ops} ops); plain {plain_ms:.5f} ms; "
              f"torch.topk of the screened scores {topk_ms:.5f} ms")
    return {"rows": r, "N": n, "M": mr, "form": form, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "max_abs_err": err, "library_ms": None,
            "topk_ms": topk_ms}


def staging_behind_k2(card: str) -> None:
    """A sharded wave's staging (`model_bank._staged`: pinned memory, a
    non-blocking copy) must not wait for the work already queued on the
    card, as an earlier wave's K2: with the stream held by a spin
    kernel, staging a 16 x 4,096 wave's four id and mask arrays must
    return to the host in under half the spin. Three trials, each
    behind its own spin, are judged on their median: the host's own
    jitter (a trial of a few ms at times reads tens of ms) is not a
    wait, and a stage that waited would lose every trial. A pageable
    copy behind the same spins is timed beside it."""
    import numpy as np
    import torch

    from onix_torch.serving.model_bank import _staged
    dev = torch.device("cuda", 0)
    arrays = [np.zeros((16, 4096), np.int32) for _ in range(4)]
    for a in arrays:
        _staged(a, dev)                 # the pinned pool's first blocks
    torch.cuda.synchronize()
    host = {"pinned non-blocking": [], "pageable": []}
    spin = {"pinned non-blocking": [], "pageable": []}
    for _ in range(STAGING_TRIALS):
        for label, stage in (("pinned non-blocking",
                              lambda a: _staged(a, dev)),
                             ("pageable",
                              lambda a: torch.from_numpy(a).to(dev))):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            torch.cuda._sleep(20_000_000)
            e1.record()
            t0 = time.perf_counter()
            for a in arrays:
                stage(a)
            host[label].append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            spin[label].append(e0.elapsed_time(e1))
    med = {k: statistics.median(v) for k, v in host.items()}
    med_spin = statistics.median(spin["pinned non-blocking"])
    say(card, f"staging behind a busy stream (spin median {med_spin:.3f} "
              f"ms pinned, {statistics.median(spin['pageable']):.3f} ms "
              f"pageable): 4 arrays of a 16 x 4,096 wave take "
              f"{med['pinned non-blocking']:.3f} ms on the host pinned "
              f"and non-blocking, {med['pageable']:.3f} ms pageable "
              f"(median of {STAGING_TRIALS}; each trial, ms: pinned "
              f"{[round(x, 3) for x in host['pinned non-blocking']]}, "
              f"pageable {[round(x, 3) for x in host['pageable']]})")
    if med["pinned non-blocking"] > 0.5 * med_spin:
        raise AssertionError("a sharded wave's staging waited for the "
                             "card's queued work")


def phase_sharded_bank(card: str) -> tuple:
    """(a) The load harness at the bench shape through the sharded bank,
    "sharded" pinned through the spec, its 1, 2 and 4 homes on cuda:0
    (`OneCardDevices`): winners and scores bit-identical to the single
    bank's; K2 launches = the replay's dispatches = the sum of its
    `bank.wave.d{i}` (none with one home), every home with waves; the
    fetch wait and the batch walls. Then K2 at the first 4-home wave's
    shape (`sharded_wave_row`). Returns (that row, K2 launches)."""
    import dataclasses
    import statistics as st

    import torch

    from onix_torch.models import fused_serve as fs
    from onix_torch.serving import load_harness as lh
    from onix_torch.utils import telemetry
    spec = lh.HarnessSpec(**BENCH_SPEC)
    models, stream = lh.make_tenants(spec), lh.make_stream(spec)
    kw = dict(tol=spec.tol, max_results=spec.max_results)

    def dispatch_s():
        h = telemetry.histograms.get("span.bank.wave")
        return h.sum if h is not None else 0.0

    def run(s):
        lh.replay(lh.build_service(s, models, device="cuda"), stream,
                  **kw)                                   # warm
        svc = lh.build_service(s, models, device="cuda")
        waves0 = wave_counts()
        torch.cuda.synchronize()
        fs.launches = 0
        # From empty (admission, the first waves' collective-free
        # checks), then again with every tenant resident.
        outs = []
        for _ in range(2):
            span0 = dispatch_s()
            outs.append(lh.replay(svc, stream, **kw))
            torch.cuda.synchronize()
            outs[-1]["dispatch_s"] = dispatch_s() - span0
        waves = {k: v - waves0.get(k, 0) for k, v in wave_counts().items()
                 if v - waves0.get(k, 0)}
        return svc, outs, fs.launches, waves
    launches = 0
    _, (_, single), k2, _ = run(spec)
    launches += k2
    captured = []
    real = fs.bank_score_fused

    def capture(*a, **k):
        if not captured:
            captured.append((a, k))
        return real(*a, **k)
    walls = {}
    for homes in PLACEMENT_HOMES:
        s = dataclasses.replace(spec, devices=homes, shard_form="sharded")
        with OneCardDevices(max(PLACEMENT_HOMES)):
            if homes == max(PLACEMENT_HOMES):
                fs.bank_score_fused = capture
            try:
                svc, (first, out), k2, waves = run(s)
            finally:
                fs.bank_score_fused = real
        launches += k2
        if not (same_winners(out, single) and same_winners(first, single)):
            raise AssertionError(f"sharded bank, {homes} home(s): winners "
                                 "differ from the single bank's")
        bank = svc.bank
        if bank.shard_form_resolved() != "sharded" \
                or bank.n_devices() != homes:
            raise AssertionError(f"sharded bank, {homes} home(s): form "
                                 f"{bank.shard_form_resolved()}, "
                                 f"{bank.n_devices()} devices")
        check_launches(f"sharded bank {homes} home(s): K2", k2,
                       first["dispatches"] + out["dispatches"])
        if homes > 1:
            check_launches(f"sharded bank {homes} homes: waves",
                           sum(waves.values()), k2)
            if sorted(waves) != [f"bank.wave.d{i}" for i in range(homes)]:
                raise AssertionError(f"sharded bank {homes} homes: waves "
                                     f"{waves}")
        elif waves:
            raise AssertionError(f"one home ran the wave phase: {waves}")
        walls[homes] = out["wall_s"]
        say(card, f"sharded bank, {homes} home(s) on cuda:0: {len(stream)} "
                  f"requests of {spec.events_per_request} events, batches "
                  f"of {spec.batch_requests}: winners and scores "
                  f"bit-identical to the single bank; K2 launches {k2} = "
                  f"dispatches; waves {json.dumps(waves)}; from empty: "
                  f"wall {first['wall_s']:.4f} s, dispatch phase "
                  f"(bank.wave spans) {first['dispatch_s'] * 1e3:.3f} ms, "
                  f"fetch wait {first['fetch_wait_us']} us; resident: "
                  f"dispatch phase {out['dispatch_s'] * 1e3:.3f} ms, "
                  f"fetch wait {out['fetch_wait_us']} us, replay wall "
                  f"{out['wall_s']:.4f} s, batch p50 "
                  f"{out['latency_p50_ms']} ms, p99 "
                  f"{out['latency_p99_ms']} ms; {out['events_per_sec']} "
                  f"events/s; per-home residency "
                  f"{json.dumps(bank.tier_stats()['hbm']['per_device_resident'])}")
    _, (_, again), k2, _ = run(spec)
    launches += k2
    say(card, f"sharded bank, resident replays: single bank wall "
              f"{single['wall_s']:.4f} s (first) and {again['wall_s']:.4f} "
              f"s (last), against "
              f"{json.dumps(walls)} by homes; median "
              f"{st.median(walls.values()):.4f} s")
    staging_behind_k2(card)
    args, wkw = captured[0]
    row = sharded_wave_row(card, args, wkw)
    return row, launches


def phase_serve_sharded(card: str, root: pathlib.Path) -> int:
    """(b) `onix serve` with serving.bank_shard=sharded on the card, its
    bank over 4 homes on cuda:0 (`OneCardDevices`), against the same
    server with the single form: one /score of 8 harness tenants gives
    the single form's answer and the plain single-tenant path's bit for
    bit; K2 launches equal the bank's dispatches. Returns K2's
    launches."""
    import numpy as np
    import torch

    from onix_torch.config import OnixConfig
    from onix_torch.models import fused_serve as fs
    from onix_torch.oa.serve import serve_background
    from onix_torch.utils.obs import counters
    store = root / "placements_serve"
    cfg0 = OnixConfig()
    cfg0.store.root = str(store)
    cfg0.validate()
    harness = write_harness_tenants(cfg0.serving.models_dir, seed=5)
    names = sorted(harness)[:PLACEMENT_SERVE_REQUESTS]
    rng = np.random.default_rng(6)
    reqs = [(t, rng.integers(0, HARNESS_D, PLACEMENT_SERVE_EVENTS)
             .astype(np.int32),
             rng.integers(0, HARNESS_V, PLACEMENT_SERVE_EVENTS)
             .astype(np.int32)) for t in names]
    tol, m = cfg0.pipeline.tol, cfg0.pipeline.max_results
    body = {"requests": [{"tenant": t, "doc_ids": d.tolist(),
                          "word_ids": w.tolist()} for t, d, w in reqs],
            "tol": tol, "max_results": m}
    oracle = harness_oracle("cuda")
    tables = {t: tuple(torch.from_numpy(a).to("cuda") for a in harness[t])
              for t in names}
    answers, launches = {}, 0
    for shard in ("single", "sharded"):
        cfg = OnixConfig()
        cfg.store.root = str(store)
        cfg.serving.serve_form = "fused"
        cfg.serving.bank_shard = shard
        cfg.validate()
        with OneCardDevices(4):
            srv, port = serve_background(cfg, device="cuda")
            try:
                torch.cuda.synchronize()
                fs.launches = 0
                d0 = counters.get("bank.dispatch")
                out, wall = http_json(port, "POST", "/score", body)
                torch.cuda.synchronize()
                k2 = fs.launches
                dispatches = counters.get("bank.dispatch") - d0
                stats, _ = http_json(port, "GET", "/bank/stats")
            finally:
                srv.shutdown()
                srv.server_close()
        launches += k2
        check_launches(f"serve {shard}: K2", k2, dispatches)
        tiers = stats["tiers"]
        if (tiers["shard_form"], tiers["n_devices"]) != (shard, 4):
            raise AssertionError(f"serve {shard}: tiers {tiers}")
        for (t, d, w), res in zip(reqs, out["results"]):
            check_winners(res, oracle(tables, t, d, w, tol, m),
                          f"serve {shard} {t}")
        answers[shard] = [(r["indices"], r["scores"])
                          for r in out["results"]]
        say(card, f"serve -s serving.bank_shard={shard}: one /score of "
                  f"{len(reqs)} tenants x {PLACEMENT_SERVE_EVENTS} events "
                  f"in {wall:.3f} s, bank over {tiers['n_devices']} homes "
                  f"on cuda:0, per-home residency "
                  f"{json.dumps(tiers['hbm']['per_device_resident'])}; "
                  f"K2 launches {k2} = dispatches; winners equal to the "
                  "plain single-tenant path")
    if answers["sharded"] != answers["single"]:
        raise AssertionError("serve: the sharded form's answer differs from "
                             "the single form's")
    return launches


def phase_fleet_dp(card: str, root: pathlib.Path) -> tuple:
    """(c) The fleet refit at PLACEMENT_FLEET over dp 1, 2 and 4, the dp
    positions on cuda:0 (`OneCardMesh`): every ledger body and every
    tenant's lineage identical to dp 1's; K1 launches = sweeps x blocks
    x distinct devices summed over the class refits, K2's the ok
    tenant-days'. K1's lane form at FLEET_DP_LANES, a padded class
    shape that the fleet week's rows do not cover, is held and timed
    (`lane_case`). Returns (that row, K1 launches, K2 launches)."""
    import torch

    from onix_torch.models import fused_serve as fs
    from onix_torch.models import sample_count
    from onix_torch.pipelines.fleet import (run_fleet, tenant_lineage,
                                            tenant_name)
    from onix_torch.utils.obs import counters
    wk = PLACEMENT_FLEET
    kw = {k: wk[k] for k in ("n_events", "n_sweeps", "n_topics",
                             "max_results", "seed")}
    runs = {}
    k1_all = k2_all = 0
    for dp in (1,) + PLACEMENT_FLEET_DP:
        for ns in ("fleet", "campaign", "daily", "faults", "ckpt"):
            counters.reset(ns)
        torch.cuda.synchronize()
        sample_count.launches = fs.launches = 0
        t0 = time.perf_counter()
        with OneCardMesh():
            m = run_fleet(wk["days"], wk["tenants"], root / f"fleet_dp{dp}",
                          plants={1: wk["plant"]}, dp=dp, device="cuda",
                          **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k1, k2 = sample_count.launches, fs.launches
        k1_all += k1
        k2_all += k2
        agg = m["aggregate"]
        if agg["ok_tenant_days"] != wk["days"] * wk["tenants"]:
            raise AssertionError(f"fleet dp {dp}: {agg}")
        check_launches(f"fleet dp {dp} K1", k1, k1_calls(m["dispatches"]))
        check_launches(f"fleet dp {dp} K2", k2, agg["ok_tenant_days"])
        runs[dp] = m
        lanes = sorted({(d["class"], d["lanes"],
                         -(-d["lanes"] // dp) * dp) for d in m["dispatches"]})
        say(card, f"fleet dp {dp} on cuda:0: {wk['tenants']} tenants x "
                  f"{wk['days']} days, {kw['n_events']} events, K "
                  f"{kw['n_topics']}: {agg['ok_tenant_days']} ok tenant-days; "
                  f"class refits (class, lanes, padded) {lanes}; K1 launches "
                  f"{k1} (devices a refit "
                  f"{sorted({d['devices'] for d in m['dispatches']})}), K2 "
                  f"{k2}; fit wall {agg['fit_wall_s']} s, run wall "
                  f"{wall:.2f} s")
        if dp == 1:
            continue
        same = fleet_identity(m) == fleet_identity(runs[1]) and all(
            tenant_lineage(m, tenant_name(u))
            == tenant_lineage(runs[1], tenant_name(u))
            for u in range(wk["tenants"]))
        if not same:
            raise AssertionError(f"fleet dp {dp}: artifacts differ from "
                                 "dp 1's")
        say(card, f"fleet dp {dp}: ledger bodies, models, winners, lineage "
                  "and nudge digests bit-identical to dp 1's")
    t, b, v_pad, d_pad = FLEET_DP_LANES
    row = lane_case(card, "fleet class padded for dp 2", t, b,
                    wk["n_topics"], v_pad, d_pad, True, seed=151)
    return row, k1_all, k2_all


def phase_placement_refusals(card: str, root: pathlib.Path) -> None:
    """(d) The refusals one card implies, by message: a harness bank of
    2 devices and a dp 2 fleet without a laying on cuda:0."""
    from onix_torch.pipelines.fleet import run_fleet
    from onix_torch.serving import load_harness as lh
    spec = lh.HarnessSpec(**{**BENCH_SPEC, "n_tenants": 2}, devices=2)
    cases = [
        ("harness spec.devices=2", "spec.devices=2 > available 1",
         lambda: lh.build_service(spec, lh.make_tenants(spec),
                                  device="cuda")),
        ("run_fleet(dp=2)", "needs 2 devices, have 1",
         lambda: run_fleet(1, 2, root / "fleet_refused", n_events=600,
                           dp=2, device="cuda")),
    ]
    for what, msg, call in cases:
        try:
            call()
        except ValueError as e:
            if msg not in str(e):
                raise AssertionError(f"{what}: refused with {e!r}, not "
                                     f"{msg!r}") from e
            say(card, f"refusal: {what} on one card: {e}")
            continue
        raise AssertionError(f"{what} ran on one card")


def phase_placements(card: str, root: pathlib.Path) -> tuple:
    """Phase 16: (a)-(d). Returns ({K2 row, K1 row or None}, K1
    launches, K2 launches)."""
    t0 = time.perf_counter()
    wave_row, k2_bank = phase_sharded_bank(card)
    k2_serve = phase_serve_sharded(card, root)
    lane_row, k1, k2_fleet = phase_fleet_dp(card, root)
    phase_placement_refusals(card, root)
    say(card, f"phase 16 wall {time.perf_counter() - t0:.1f} s")
    return ({"sharded_wave": wave_row, "fleet_dp": lane_row}, k1,
            k2_bank + k2_serve + k2_fleet)


GROUPS_LL_RTOL = 1e-6


# `--groups`: the fabric over the cards, a card (or two) a worker; the
# drill as phase 15's.
CARD_FABRIC_KW = dict(lease_s=15.0, beat_s=0.5, collective_deadline_s=120.0,
                      device="cuda")
# The in-process fold's two forms, each timed in a fresh process: the
# port's peer copies through the home card, and an NCCL all-reduce
# among the cards (`nccl_fold`).
FOLDS = ("peer", "nccl")
# The untimed runs that log NCCL's INFO lines run this many sweeps.
INFO_SWEEPS = 2


def nccl_fold(self, bufs: list, head: int) -> None:
    """`ShardedGibbsLDA._reduce_groups` as an NCCL all-reduce among one
    process's cards (`torch.cuda.nccl`): the form the port's peer copies
    are timed against (one process only)."""
    from torch.cuda import nccl
    nccl.all_reduce(bufs)


def nccl_env(workdir) -> dict:
    """An environment that logs NCCL's INFO lines under `workdir`, one
    file a process (for the untimed runs only: the logging slows NCCL's
    start)."""
    return {"NCCL_DEBUG": "INFO",
            "NCCL_DEBUG_FILE": str(pathlib.Path(workdir) / "nccl.%p.log")}


def nccl_info(paths) -> str:
    """The transports that NCCL's INFO lines in `paths` name ("... via
    P2P/CUMEM"), each with its count of connections, and each
    communicator's "Init timings" line."""
    seen: dict = {}
    inits = []
    for path in sorted(map(pathlib.Path, paths)):
        text = path.read_text(errors="replace") if path.exists() else ""
        for m in re.finditer(r" via (\S+)", text):
            seen[m.group(1)] = seen.get(m.group(1), 0) + 1
        inits += [m.group(1).strip()
                  for m in re.finditer(r"Init timings(.*)", text)]
    via = ", ".join(f"{k} x{v}" for k, v in sorted(seen.items()))
    return (f"transports {via or 'none logged'}; init timings "
            f"{' | '.join(inits) or 'none logged'}")


def sync_cards() -> None:
    import torch
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def timed_supersteps(model) -> list:
    """Note the wall of each superstep of `model`'s fit, every card
    synchronised at its end, in the returned list."""
    walls: list = []
    real = model.superstep

    def superstep(*args, **kw):
        t0 = time.perf_counter()
        out = real(*args, **kw)
        sync_cards()
        walls.append(time.perf_counter() - t0)
        return out
    model.superstep = superstep
    return walls


def split_wall(fit: dict) -> str:
    """A fit's wall as start-up (layout and initial state), its first
    superstep and the rest."""
    w, steps = fit["walls"], fit["steps"]
    return (f"fit {fit['wall']:.3f} s = layout and init "
            f"{w['layout'] + w['init']:.3f} + first superstep "
            f"{steps[0]:.3f} + {len(steps) - 1} more {sum(steps[1:]):.3f} "
            f"+ estimates {w['estimates']:.3f}")


def same_fit(what: str, a: dict, b: dict) -> float:
    """Hold fit `a` to `b`: z, theta and phi_wk bit for bit, the ll
    history within GROUPS_LL_RTOL (an f32 sum over each device group's
    [L_g, B] stack, which CUDA splits by the stack's shape) at every
    sweep of `a`'s, which ends where `b`'s does (a resumed fabric's
    history starts at its resume). Returns the ll's largest relative
    difference."""
    import numpy as np
    for name in ("z", "theta", "phi_wk"):
        if not np.array_equal(np.asarray(a[name]), np.asarray(b[name])):
            raise AssertionError(f"{what}: {name} differs")
    ref = dict(b["ll_history"])
    sweeps = [s for s, _ in a["ll_history"]]
    if not sweeps or sweeps[-1] != b["ll_history"][-1][0] \
            or not set(sweeps) <= set(ref):
        raise AssertionError(f"{what}: ll history at sweeps {sweeps}")
    rel = max(abs(v - ref[s]) / abs(ref[s]) for s, v in a["ll_history"])
    if rel > GROUPS_LL_RTOL:
        raise AssertionError(f"{what}: ll history differs (max relative "
                             f"{rel:.3e})")
    return rel


def mesh_fit(corpus, devices, form: str, **fit_kw) -> dict:
    """phase 5's day on dp 2 x mp 2 over `devices`, sync or async
    tau=1: its arrays on the host, ll history, walls (each superstep's
    too) and K1 launches."""
    from onix_torch.config import LDAConfig
    from onix_torch.models import sample_count
    from onix_torch.parallel.mesh import make_mesh
    from onix_torch.parallel.sharded_gibbs import ShardedGibbsLDA
    kw = {"merge_form": "async", "merge_staleness": 1} \
        if form == "async" else {}
    model = ShardedGibbsLDA(LDAConfig(**kw), corpus.n_vocab,
                            mesh=make_mesh(2, 2, devices=devices))
    steps = timed_supersteps(model)
    sync_cards()
    before = sample_count.launches
    t0 = time.perf_counter()
    fit = model.fit(corpus, **fit_kw)
    sync_cards()
    return {"wall": time.perf_counter() - t0, "steps": steps,
            "walls": fit["walls"], "k1": sample_count.launches - before,
            "groups": len(model._groups), "z": fit["state"].z.cpu().numpy(),
            "theta": fit["theta"], "phi_wk": fit["phi_wk"],
            "ll_history": fit["ll_history"]}


def fold_child(work: str, fold: str, what: str) -> None:
    """`--groups`, in a fresh process, so that its first fit pays its
    own start: the in-process fold as the port runs it ("peer") or as
    `nccl_fold` ("nccl"). `what` "mesh": phase 5's day (`work`/
    corpus.pkl) on dp 2 x mp 2 over cuda:0..3, sync then async tau=1;
    "scale": `run_scale(10^6)` over every card; "info": a short sync
    mesh fit, for NCCL's INFO lines. Writes what it measured to
    `work`/{fold}-{what}.pkl."""
    import pickle

    import torch

    from onix_torch.parallel.sharded_gibbs import ShardedGibbsLDA
    from onix_torch.pipelines.scale import run_scale
    if fold == "nccl":
        ShardedGibbsLDA._reduce_groups = nccl_fold
    work = pathlib.Path(work)
    n = torch.cuda.device_count()
    devices = [f"cuda:{q % n}" for q in range(4)]
    out = {}
    if what == "scale":
        with FitStates(ShardedGibbsLDA) as seen:
            t0 = time.perf_counter()
            m = run_scale(DAY_EVENTS, device="cuda")
            sync_cards()
        (fit, _), = seen.seen
        out = {"run": time.perf_counter() - t0, "mesh": m["mesh"],
               "devices": m["devices"],
               "fit_s": m["walls_seconds"]["gibbs_fit"],
               "walls": fit["walls"],
               "planted": (m["planted_in_bottom_k"],
                           m["planted_anomalies"]),
               "z": fit["state"].z.cpu().numpy(), "theta": fit["theta"],
               "phi_wk": fit["phi_wk"], "ll_history": fit["ll_history"]}
    else:
        corpus = pickle.loads((work / "corpus.pkl").read_bytes())
        for form in (("sync",) if what == "info" else ("sync", "async")):
            out[form] = mesh_fit(corpus, devices, form,
                                 **({"n_sweeps": INFO_SWEEPS}
                                    if what == "info" else {}))
    (work / f"{fold}-{what}.pkl").write_bytes(pickle.dumps(out))


def run_fold_child(work: pathlib.Path, fold: str, what: str,
                   env: dict | None = None) -> dict:
    """Run `fold_child` in a fresh process (NCCL_DEBUG unset unless
    `env` sets it) and return what it wrote."""
    import pickle
    child_env = {k: v for k, v in os.environ.items()
                 if not k.startswith("NCCL_DEBUG")}
    child_env.update(env or {})
    with bounded("fold child", f"the {fold} fold's {what} child") as lim:
        proc = subprocess.run(
            [sys.executable, "-c", "import sys, chip_smoke; "
             "chip_smoke.fold_child(*sys.argv[1:])", str(work), fold, what],
            cwd=str(HERE), env=child_env, capture_output=True, text=True,
            timeout=lim)
    if proc.returncode != 0:
        raise AssertionError(f"groups: the {fold} fold's {what} child "
                             f"exited {proc.returncode}:\n"
                             f"{(proc.stdout + proc.stderr)[-3000:]}")
    return pickle.loads((work / f"{fold}-{what}.pkl").read_bytes())


def phase_card_groups(card: str, corpus, work: pathlib.Path) -> None:
    """`--groups` (iii): the shard arm with its positions on several
    cards (each card's lanes, views, draws and rings on it) against the
    same mesh on one card: bit-identical fits, sync and async tau=1, on
    phase 5's day. The in-process fold runs in both forms, each in a
    fresh process with NCCL_DEBUG unset: the port's peer copies and an
    NCCL all-reduce among the cards; each fit's wall split into
    start-up, its first superstep and the rest. Then, untimed, a short
    fit of the NCCL form with NCCL's INFO lines: its transports and
    its communicators' init timings."""
    import pickle

    import torch
    (work / "corpus.pkl").write_bytes(pickle.dumps(corpus))
    n = min(4, torch.cuda.device_count())
    got = {fold: run_fold_child(work, fold, "mesh") for fold in FOLDS}
    for form in ("sync", "async"):
        tau = " tau=1" if form == "async" else ""
        one = mesh_fit(corpus, ["cuda:0"] * 4, form)
        say(card, f"groups: {form}{tau} dp 2 x mp 2 on one card "
                  f"({one['groups']} group): {split_wall(one)}; K1 "
                  f"{one['k1']}, final ll {one['ll_history'][-1][1]:.6f}")
        for fold in FOLDS:
            fit = got[fold][form]
            rel = same_fit(f"groups {form}{tau}, {fold} fold: {n} cards "
                           "against one", fit, one)
            say(card, f"groups: {form}{tau} dp 2 x mp 2 on {n} cards "
                      f"({fit['groups']} groups), {fold} fold, a fresh "
                      f"process: {split_wall(fit)}; K1 {fit['k1']}; z, "
                      f"theta, phi_wk bit-identical to one card, ll "
                      f"within {rel:.3e} relative (bar {GROUPS_LL_RTOL})")
    info = work / "info"
    info.mkdir()
    run_fold_child(work, "nccl", "info", nccl_env(info))
    say(card, f"groups: untimed, the nccl fold over {n} cards with NCCL's "
              f"INFO lines: {nccl_info(info.glob('nccl.*.log'))}")


class FabricEnv:
    """While active, `hostfabric.run_fit` (which `run_scale` calls for
    `fit_hosts` > 1) gives its workers `env(workdir)` besides their own
    environment and a `timeout_s`, and keeps each run's result in
    `runs`."""

    def __init__(self, env, timeout_s: float):
        self.env, self.timeout_s, self.runs = env, timeout_s, []

    def __enter__(self):
        from onix_torch.parallel import hostfabric
        self.mod, self.real = hostfabric, hostfabric.run_fit

        def run_fit(corpus, cfg, workdir, **kw):
            extra = self.env(workdir)
            kw["worker_env"] = {i: {**extra.get(i, {}),
                                    **kw.get("worker_env", {}).get(i, {})}
                                for i in range(kw.get("n_hosts", 2))}
            kw.setdefault("timeout_s", self.timeout_s)
            out = self.real(corpus, cfg, workdir, **kw)
            self.runs.append((pathlib.Path(workdir), out))
            return out
        hostfabric.run_fit = run_fit
        return self

    def __exit__(self, *exc):
        self.mod.run_fit = self.real
        return False


def phase_group_fabric(card: str, corpus, work: pathlib.Path) -> None:
    """`--groups` (i) and (ii): the host fabric over the cards, over
    NCCL. (i) `hostfabric.run_fit` on phase 5's day at the default
    config, 2 workers x 1 card (cuda:0, cuda:1), clean and with the
    SIGKILL drill, and (with 4 cards) 4 workers x 1 card and 2 workers
    x 2 cards (each worker folds its two cards first, then the group
    all-reduces): z, theta and phi_wk bit-identical to the in-process
    fit of as many positions on one card, each worker's K1 launches
    sweeps x blocks x its cards. (ii) `run_scale(10^6, fit_hosts=2)`
    over two cards against the same call with both workers on cuda:0
    (gloo): theta and phi_wk bit-identical. Each timed run prints its
    backend and walls with NCCL_DEBUG unset; then short untimed runs of
    the NCCL fabrics print NCCL's transports and init timings."""
    import numpy as np
    import torch

    from onix_torch.config import LDAConfig
    from onix_torch.parallel import hostfabric
    from onix_torch.pipelines.scale import run_scale
    n = torch.cuda.device_count()
    lim = WAIT_LIMITS["card fabric generation"]
    shapes = ((2, 1), (4, 1), (2, 2)) if n >= 4 else ((2, 1),)

    def fabric(wd, workers, cards, env=None, **kw):
        with FabricEnv(env or (lambda w: {}), lim):
            return hostfabric.run_fit(corpus, LDAConfig(), wd,
                                      n_hosts=workers, local_devices=cards,
                                      **CARD_FABRIC_KW, **kw)
    refs = {}
    for workers, cards in shapes:
        positions = workers * cards
        if positions not in refs:
            refs[positions] = shard_fit(
                card, corpus, card_mesh(positions),
                f"in-process dp {positions} on cuda:0")
            refs[positions]["z"] = refs[positions]["state"].z.cpu().numpy()
        ref = refs[positions]
        runs = (("clean", None), ("drill", FABRIC_KILL)) \
            if (workers, cards) == (2, 1) else (("clean", None),)
        for label, kill in runs:
            t0 = time.perf_counter()
            out = fabric(work / f"fabric{workers}x{cards}-{label}", workers,
                         cards, kill_plan=kill)
            wall = time.perf_counter() - t0
            m = out["manifest"]
            tag = (f"groups: fabric {workers} workers x {cards} card(s) "
                   f"{label}")
            rel = same_fit(f"{tag} against in-process dp {positions}",
                           {**out, "z": out["arrays"]["z"]}, ref)
            if m["backend"] != "nccl":
                raise AssertionError(f"{tag}: ran {m['backend']}")
            # One K1 call a block for each card of a worker.
            want = [ref["k1"] * cards] * workers
            if kill is None and (m["deaths"] or m["k1_launches"] != want):
                raise AssertionError(f"{tag}: deaths {m['deaths']}, "
                                     f"launches {m['k1_launches']}")
            if kill is not None and (len(m["deaths"]) != 1
                                     or m["restarts"] != 1
                                     or m["resume_sweeps"][1] < 0):
                raise AssertionError(f"{tag}: deaths {m['deaths']}, resume "
                                     f"{m['resume_sweeps']}")
            say(card, f"{tag}: {m['backend']} process group; wall "
                      f"{wall:.2f} s, generations "
                      f"{m['walls']['generations_s']}; deaths "
                      f"{[d['host'] for d in m['deaths']]}, resume sweeps "
                      f"{m['resume_sweeps']}; K1 launches a worker "
                      f"{m['k1_launches']}; z, theta, phi_wk bit-identical "
                      f"to the in-process fit, ll within {rel:.3e} "
                      f"relative")
    del refs

    scale = {}
    for label, cards in (("two cards", None), ("cuda:0 shared", "0")):
        def env(w, cards=cards):
            return {i: ({} if cards is None else
                        {"CUDA_VISIBLE_DEVICES": cards}) for i in range(2)}
        t0 = time.perf_counter()
        with FabricEnv(env, lim) as fab:
            m = run_scale(DAY_EVENTS, fit_hosts=2, device="cuda")
        (wd, out), = fab.runs
        fm = m["orchestration"]["fit_fabric"]
        scale[label] = out
        say(card, f"groups: run_scale({DAY_EVENTS}, fit_hosts=2) on "
                  f"{label}: {fm['backend']} process group; fit "
                  f"{m['walls_seconds']['gibbs_fit']} s, generations "
                  f"{fm['walls']['generations_s']}, K1 a worker "
                  f"{fm['k1_launches']}; run "
                  f"{time.perf_counter() - t0:.2f} s; planted "
                  f"{m['planted_in_bottom_k']} of {m['planted_anomalies']}")
        want = "nccl" if cards is None else "gloo"
        if fm["backend"] != want:
            raise AssertionError(f"groups: run_scale on {label} ran "
                                 f"{fm['backend']}, not {want}")
    a, b = scale.values()
    for name in ("theta", "phi_wk"):
        if not np.array_equal(a[name], b[name]):
            raise AssertionError(f"groups: run_scale {name} over two cards "
                                 "differs from the shared card's")
    say(card, "groups: run_scale(fit_hosts=2) over two cards (NCCL) "
              "bit-identical to both workers on cuda:0 (gloo): theta, "
              "phi_wk")

    for workers, cards in shapes[::2]:
        wd = work / f"fabric{workers}x{cards}-info"
        m = fabric(wd, workers, cards,
                   lambda w: {i: nccl_env(w) for i in range(workers)},
                   n_sweeps=INFO_SWEEPS)["manifest"]
        say(card, f"groups: untimed, fabric {workers} workers x {cards} "
                  f"card(s), {INFO_SWEEPS} sweeps with NCCL's INFO lines: "
                  f"{m['backend']}, {nccl_info(wd.glob('nccl.*.log'))}")


def phase_group_placements(card: str, work: pathlib.Path) -> None:
    """`--groups`, slice 5b: the placements over the cards themselves,
    each against one card. The sharded bank at the harness's bench shape
    with its homes on cuda:0..3 against the single bank; the fleet at
    PLACEMENT_FLEET over dp 4 (or as many cards as there are) against
    dp 1; `run_scale(10^6)` over every visible card, in a fresh process
    with each in-process fold (`fold_child`), against the same mesh
    laid on cuda:0 (`OneCardDevices`): winners, fleet artifacts, z,
    theta and phi_wk bit-identical, the scale day's ll history within
    GROUPS_LL_RTOL."""
    import dataclasses

    import torch

    from onix_torch.parallel.sharded_gibbs import ShardedGibbsLDA
    from onix_torch.pipelines.fleet import run_fleet, tenant_lineage
    from onix_torch.pipelines.scale import run_scale
    from onix_torch.serving import load_harness as lh
    n = min(torch.cuda.device_count(), 4)

    def sync_all():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
    spec = lh.HarnessSpec(**BENCH_SPEC)
    models, stream = lh.make_tenants(spec), lh.make_stream(spec)
    kw = dict(tol=spec.tol, max_results=spec.max_results)
    got = {}
    for label, s in (("single", spec),
                     ("sharded", dataclasses.replace(
                         spec, devices=n, shard_form="sharded"))):
        lh.replay(lh.build_service(s, models, device="cuda"), stream,
                  **kw)                                   # warm
        svc = lh.build_service(s, models, device="cuda")
        got[label] = lh.replay(svc, stream, **kw)
        sync_all()
        say(card, f"groups: harness bank {label} over "
                  f"{svc.bank.n_devices()} card(s): replay "
                  f"{got[label]['wall_s']:.4f} s, fetch wait "
                  f"{got[label]['fetch_wait_us']} us, residency "
                  f"{json.dumps(svc.bank.tier_stats()['hbm']['per_device_resident'])}")
    if not same_winners(got["sharded"], got["single"]):
        raise AssertionError("groups: the sharded bank over several cards "
                             "differs from the single bank")

    wk = PLACEMENT_FLEET
    fkw = {k: wk[k] for k in ("n_events", "n_sweeps", "n_topics",
                              "max_results", "seed")}
    tmp = work
    fleets = {}
    for dp in (1, n):
        t0 = time.perf_counter()
        fleets[dp] = run_fleet(wk["days"], wk["tenants"], tmp / f"dp{dp}",
                               plants={1: wk["plant"]}, dp=dp,
                               device="cuda", **fkw)
        sync_all()
        say(card, f"groups: fleet dp {dp} over {dp} card(s): fit wall "
                  f"{fleets[dp]['aggregate']['fit_wall_s']} s, run wall "
                  f"{time.perf_counter() - t0:.2f} s")
    if fleet_identity(fleets[n]) != fleet_identity(fleets[1]) or any(
            tenant_lineage(fleets[n], t) != tenant_lineage(fleets[1], t)
            for t in fleets[1]["days"][0]["tenants"]):
        raise AssertionError(f"groups: the dp {n} fleet over {n} cards "
                             "differs from dp 1")

    with FitStates(ShardedGibbsLDA) as seen, OneCardDevices(n):
        m = run_scale(DAY_EVENTS, device="cuda")
    sync_all()
    (fit, _), = seen.seen
    one = {"z": fit["state"].z.cpu().numpy(), "theta": fit["theta"],
           "phi_wk": fit["phi_wk"], "ll_history": fit["ll_history"]}
    say(card, f"groups: run_scale({DAY_EVENTS}) on one card: mesh "
              f"{m['mesh']}, fit {m['walls_seconds']['gibbs_fit']} s, "
              f"planted {m['planted_in_bottom_k']} of "
              f"{m['planted_anomalies']}")
    for fold in FOLDS:
        got = run_fold_child(work, fold, "scale")
        if got["mesh"] != {"dp": n, "mp": 1}:
            raise AssertionError(f"groups: run_scale mesh {got['mesh']}")
        rel = same_fit(f"groups: run_scale over the cards, {fold} fold, "
                       "against one card", got, one)
        w = got["walls"]
        say(card, f"groups: run_scale({DAY_EVENTS}) on the cards, {fold} "
                  f"fold, a fresh process: mesh {got['mesh']}, devices "
                  f"{got['devices']}, fit {got['fit_s']} s (layout "
                  f"{w['layout']:.3f}, init {w['init']:.3f}, sweeps "
                  f"{w['sweeps']:.3f}, estimates {w['estimates']:.3f}), run "
                  f"{got['run']:.2f} s, planted {got['planted'][0]} of "
                  f"{got['planted'][1]}; z, theta, phi_wk bit-identical "
                  f"to one card, ll within {rel:.3e} relative")
    say(card, f"groups: placements bit-identical to one card (harness "
              f"bank, fleet dp {n}, run_scale z, theta, phi_wk under both "
              f"folds; scale ll bar {GROUPS_LL_RTOL})")


def main() -> int:
    args = sys.argv[1:]
    if args not in ([], ["--groups"]):
        print("usage: chip_smoke.py [--groups]", file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    if not (HERE / "onix_torch" / "__init__.py").exists():
        print(f"chip_smoke: no onix_torch/ package beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    card = card_line()
    say(card, f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"{torch.cuda.device_count()} device(s)")
    t0 = time.perf_counter()
    if args:
        n = torch.cuda.device_count()
        if n < 2:
            raise AssertionError(f"--groups needs 2 or more cards, have {n}")
    with phase(card, 1):
        phase_build(card)
    if args:
        from onix_torch.pipelines.corpus_build import build_corpus
        from onix_torch.pipelines.synth import synth_flow_day
        from onix_torch.pipelines.words import flow_words
        table, _ = synth_flow_day(DAY_EVENTS, n_hosts=DAY_HOSTS,
                                  n_anomalies=DAY_ANOMALIES, seed=0)
        corpus = build_corpus(flow_words(table)).corpus
        with tempfile.TemporaryDirectory(prefix="onix_groups_") as tmp:
            work = pathlib.Path(tmp)
            phase_card_groups(card, corpus, work)
            phase_group_fabric(card, corpus, work)
            phase_group_placements(card, work)
        say(card, f"--groups passed in {time.perf_counter() - t0:.1f} s")
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    with phase(card, 2):
        phase_kernels(card)
        rows = phase_step(card)
        rows["sample_count"]["chains"] = phase_chain_step(card)
    with phase(card, 3):
        rows.update(phase_k2_kernel(card))
    with phase(card, 4):
        phase_fit(card)
        phase_fit_profile(card)
    with tempfile.TemporaryDirectory(prefix="onix_torch_smoke_") as tmp:
        root = pathlib.Path(tmp)
        overlap = start_overlap(root)
        try:
            with phase(card, 5):
                launches, table, planted, recall = phase_slice(card,
                                                               root / "day")
                clean = day_outputs(root / "day" / "results")
                no_fallback("phase 5")
            with phase(card, 6):
                launches.update(phase_serve(card, root / "day", table))
                chain_launches, _, _, chain_recall = phase_slice(
                    card, root / "chains", chains=8)
                say(card, f"slice: recall at 8 chains {chain_recall:.4f}, at "
                          f"one chain {recall:.4f}")
                rows["sample_count"]["chains"]["launches"] = \
                    chain_launches["sample_count"]
                no_fallback("phase 6")
            with phase(card, 8):
                small, small_planted, small_clean = small_day(card,
                                                              root / "small")
                phase_resilience(card, root, small, small_clean)
                no_fallback("phase 8")
            with phase(card, 9):
                scale_rows, host_arm = phase_scale(card, root, table, planted)
                for name, scale_row in scale_rows.items():
                    rows[name]["scale"] = scale_row
                no_fallback("phase 9")
            with phase(card, 10):
                rows["sample_count"].update(phase_sparse_svi(
                    card, root, small, small_planted,
                    small_clean["manifest"]["ll_history"][-1][1]))
                no_fallback("phase 10")
            with phase(card, 11):
                stream_row = phase_stream(card, root, small, small_planted,
                                          host_arm)
                rows["fused_serve"]["stream"] = stream_row
                launches["fused_serve"] += stream_row["launches"]
                no_fallback("phase 11")
            with phase(card, 12):
                phase_watch(card, root)
                launches["sample_count"] += phase_sessions(card)
                launches["fused_serve"] += phase_replicas(card, root, table)
                launches["fused_serve"] += phase_harness(card)
                launches["fused_serve"] += phase_forms(card)
                launches["fused_serve"] += phase_rescore(card, root, table)
                rows["fused_serve"]["gate_crossover_events"] = phase_gate(card)
            with phase(card, 13):
                rows["sample_count"]["lanes"] = phase_lane_step(card)
                k1_week, k1, k2 = phase_lifecycle(card, root, table)
                rows["sample_count"]["lanes"]["launches"] = k1_week
                launches["sample_count"] += k1
                launches["fused_serve"] += k2
                no_fallback("phase 13")
            with phase(card, 14):
                k1, k2 = phase_analyst(card, root)
                launches["sample_count"] += k1
                launches["fused_serve"] += k2
                no_fallback("phase 14")
            with phase(card, 15):
                import numpy as np
                with np.load(clean["manifest"]["model_saved"]) as saved:
                    phi_1x1 = saved["phi_wk"]
                shards, k1 = phase_shards(card, root, table, planted, phi_1x1,
                                          small)
                rows["sample_count"]["shards"] = shards
                launches["sample_count"] += k1
                no_fallback("phase 15")
            with phase(card, 16):
                placed, k1, k2 = phase_placements(card, root)
                rows["fused_serve"]["sharded_wave"] = placed["sharded_wave"]
                rows["sample_count"]["fleet_dp"] = placed["fleet_dp"]
                launches["sample_count"] += k1
                launches["fused_serve"] += k2
                no_fallback("phase 16")
            finish_overlap(card, *overlap)
        finally:
            if overlap[0].poll() is None:
                overlap[0].kill()
                overlap[0].communicate()
    for name, row in rows.items():
        row["launches"] = launches[name]
    say(card, f"all phases passed in {time.perf_counter() - t0:.1f} s")
    say(card, "waits (longest wall, s; limit): " + "; ".join(
        f"{k} {v:.2f} ({WAIT_LIMITS[k.split(': ', 1)[1]]:.0f})"
        for k, v in WAIT_WALLS.items()))
    print(card)
    print(json.dumps({"phase_walls": dict(sorted(
        PHASE_WALLS.items(), key=lambda kv: int(kv[0])))}))
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
