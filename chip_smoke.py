"""GPU smoke run of the PyTorch/CUDA port (bdm_db1_tpu_torch) on one card.

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --phases build,kernels
    python3 chip_smoke.py --phases build,kernels,eval_loss
    python3 chip_smoke.py --phases build,kernels,train
    python3 chip_smoke.py --phases build,train,evaluate_rl
    python3 chip_smoke.py --phases build,pretrain
    python3 chip_smoke.py --phases build,pretrain_vision,evaluate_rl_image
    python3 chip_smoke.py --phases build,generate
    python3 chip_smoke.py --phases build,kernels,serve_spec,stateless
    python3 chip_smoke.py --phases build,pretrain_vision,evaluate_rl_text
    python3 chip_smoke.py --phases build,remat,serve_preln
    python3 chip_smoke.py --phases build,data_parallel
    python3 chip_smoke.py --phases build,tensor_parallel
    python3 chip_smoke.py --phases build,pipeline
    python3 chip_smoke.py --phases build,tensor_parallel_nccl   # 4 cards

Phases, each printing one JSON line:

* ``build``      — nvcc builds every CUDA source of the port's main paths
  (one nvcc per source, all started together).
* ``kernels``    — each kernel against its plain PyTorch version at the
  db1_1p2b serving and evaluation shapes and at one small ragged shape,
  with its time, its bound, the plain version's time and one PyTorch
  library call's time as a yardstick: K1/K2 on a bf16 cache (B = 40), K6/K7
  on an int8 cache with scales made by ``quantize_kv_rows`` (B = 56), K8
  equal to K7 on the transposed scales (M = 1024, H = 16, Dh = 128; Q = 19
  and 26 for the primes; a layer index other than 0; untimed, a ragged
  decode and prime at M = 200 (Q 5) and at M = 201 (Q 17 for the prime)
  with more (head, row) pairs than SMs, and K1/K2 at the pretrain
  rollouts' B 1 with Q 19 and 26); timed too: K2/K7 at the bucket widths
  Q 24 and 32 and at the speculative prime (Q 29) and verify (Q 5), and
  K1 at the generators' B 8. K9 at the four trunk
  matrices and the row counts of the int8 serve (56, 1064, 1344, 1456,
  14336: timed, two calls bitwise equal at 56, 1064 and 1344 rows) and at 24
  untimed edge shapes (a K split with a shorter last split among them),
  the host time of a K9 call, the W8A8 int32 product against the exact
  one, and K3 (out, m, l) at the validation
  forward's shape (B 4, qlen = klen = 1024, causal), the memory trunk's
  (B 4, qlen 256, klen 1280, same_length window) and a ragged one (B 1,
  qlen 100, klen 1124), the realigned image prime (untimed) and, timed,
  the caption prime (B 8, qlen 206, klen 1230), the 64-token text
  prompt (B 8, klen 1088) and the stateless window (B 1 and B 8, qlen =
  klen = 1024, no memory); K4 and K5 (the six gradients of the rel-attention
  backward) and the preparation's delta at the same three shapes from a
  seeded upstream gradient.
* ``serve``      — db1_1p2b in bf16 with random weights from a seed serves
  40 lockstep HalfCheetah-geometry envs (17 obs tokens, 6 continuous
  actions) with strict-length expert prompts through the port's
  ``evaluate_envs_lockstep`` and a ``DecoderPool`` with the default
  geometry buckets (the 19-token steady prime padded to 24, the prompt's
  last slice to its bucket; the widths are printed); checks the kernels'
  launch counts against the chunk plan, the action tokens' range, and,
  layer by layer, the kernel route against the plain ring branch on one
  prime and one single-token forward; reads how far bf16 moves each layer
  from an f32 copy. Then 8 envs from one cache, padded and unpadded: the
  first steady prime's logits both ways and the share of equal actions
  over 4 env steps.
* ``serve_int8`` — the same at 56 envs with the int8 ring cache and int8
  trunk weights (decode_cache_dtype = decode_weight_dtype = "int8", bf16
  activations, one cohort): K6, K7 and K9 launches against the plan (K9
  also by row count), the action range, and the layer-by-layer route
  check on the int8 cache.
* ``eval_loss``  — the validation loss of db1_1p2b in bf16 (random weights
  from a seed) over 8 micro-batches of 4 x 1024 tokens: packed
  ``RLFullDataset`` samples (prompts on) of a seeded HalfCheetah-geometry
  ``FakeContinuousEnv`` dataset, its valid split, through
  ``SequentialSampler``, ``collate_modalities`` and the port's
  ``evaluate_loss``; checks 24 K3 launches per forward, a finite loss, K3
  against ``rel_attention`` layer by layer at the attention output, and the
  loss through both routes; reads tokens/sec, ms per micro-batch and the
  device idle share. Then the trunk's kernel gate: db1_tiny (head dim 16)
  at seq 1024 under "auto" gives a finite loss with no K3 launch.
* ``train``      — training of db1_1p2b (bf16 activations, f32 parameters,
  random weights from a seed, the ModelConfig dropout rates, the default
  AdamW chain) on the train split of the same dataset through
  ``RandomSampler``, ``StratifiedGatoLoader`` (micro 4, accum 2: 2 x 4 x
  1024 tokens a step) and the port's ``Trainer.train()``: one warm-up step,
  then 8 counted steps, each ending in a host read of the loss; checks
  K3 = K4 = K5 = 24 x 2 x 8 launches, finite losses (the first near log V,
  the last below it), finite and changed parameters, and a gradient route
  check (layer by layer the six attention gradients through K3-K5 against
  autograd through ``rel_attention``; the whole model's gradient through
  both routes under the same dropout masks); reads tokens/sec, the median
  step, the device idle share and the peak memory. Then, outside the
  timed window, the resume check: the whole train state (f32 parameters
  and moments, the step, the dropout generator) saved through
  ``CheckpointManager``, one step on a fixed batch (loss L_a), a restore
  into the same objects (every parameter and moment with its saved
  float64 sum and raw-bit sum), the step again (L_b == L_a bitwise); reads
  the bytes on disk and the save and restore seconds.
* ``evaluate_rl`` — needs ``train``: the RL evaluation driver
  ``evaluate_rl.main`` at its default geometry buckets on the card,
  serving the train phase's checkpoint
  as db1_1p2b in bf16 over two registered HalfCheetah-geometry envs
  (caches written with ``save_cache``), 20 trials each in one lockstep
  cohort of 40, 8 env steps; checks that ``load_params`` reads the port
  checkpoint (every weight equal to the saved one cast to bf16), two
  records of 20 finite-return trials, ``results.output`` with their two
  lines and the K1/K2 launches of the serve's plan; reads the driver's
  wall time and actions/sec. The checkpoint is deleted at the end.
* ``pretrain``   — the pretraining driver ``pretrain.main(cfg,
  device="cuda")`` at db1_1p2b (bf16 activations, f32 parameters, random
  weights from ``train.seed``) on a 0.5 text / 0.5 RL mixture: a seeded
  synthetic English-like corpus (2,000 documents of 5-100 sentences)
  through ``preprocess.main`` with the byte tokenizer, and the
  HalfCheetah-geometry cache (20 episodes x 200 steps) with its env
  registered; micro-batch 4 x 1024 (2 text rows, 2 RL rows), accum 2, 6
  iterations, the eval hook at the 6th (the validation loss over one
  batch, 2 rollouts of 8 steps on the training weights), the final
  checkpoint. Checks every batch's groups, the launches of K3-K5 (24 x 2
  x 6 training forwards and backwards, 24 x 2 validation forwards) and
  K1/K2 (the rollouts' plan), finite losses (the first within 1.0 of
  log V, the last below it), the metric keys and the step-6 checkpoint;
  reads tokens/sec over steps 2-6, the median step, the peak memory, the
  eval tick, the save and the preprocessing. Then, outside the counted
  run, on the trained model: the kernel route against the plain ring
  branch layer by layer at B 1 (one prime, one q = 1 forward), and one
  more step on the last batch, profiled (device busy and idle share).
* ``pretrain_vision`` — ``pretrain.main`` at db1_1p2b on a four-group
  mixture made from a seed: 0.4 RL tensor rows (the pretrain phase's
  cache), 0.2 image RL (``fake-image-v0`` trajectories of 80 x 80 frames,
  25 patches a frame), 0.2 captioning and 0.2 VQA (COCO-format JSONs with
  8 inline 224 x 224 images each: 196 patches, caption budget 829); a row
  of each group a micro-batch, accum 2, 6 iterations, the validation loss
  at the 6th with the default ``eval.ic_vqa_num_samples``: the 8
  captions and 8 VQA answers of the valid splits (one K3 prime and a K1
  step a further token each); the final checkpoint. Checks the groups,
  K3-K5 and K1 launches, finite losses, the caption and VQA metric keys,
  the checkpoint and that no PIL was imported; then the
  ``train`` phase's gradient route check on an image micro-batch, one
  warmed step profiled, the vision tower's forward and backward over
  that step's frames profiled alone (its share of the step), and the
  caption generator on the trained model: tokens/sec, launches per prime
  and per token, and the share of tokens equal to the plain routes'.
* ``evaluate_rl_image`` — needs ``pretrain_vision``: ``evaluate_rl.main``
  serves its checkpoint in bf16 on ``fake-image-v0`` at 80 x 80, 40
  episodes x 8 steps in one cohort with an expert prompt whose first prime
  ``_image_chunk_plan`` slices; checks the weights read, the serve route
  check on the image geometry (B 40), the records and the K1/K2 launches
  of the slice plan (the 27-token steady prime padded to 32).
* ``generate``   — ``TextGenerator`` at db1_1p2b in bf16 (random weights
  from a seed): 8 byte-token prompts of 64 tokens, 32 greedy tokens each;
  checks one K3 launch a layer for the prompt and one K1 launch a layer
  for each further token, and that every token is a text id; reads the
  generated tokens/sec and the share of tokens equal to the plain
  routes' chain.
* ``serve_spec`` — speculative (Jacobi) decode: the ``serve``
  configuration with ``decode_speculative`` (40 envs, 8 steps): the
  steady prime [6 deferred actions || 17 obs || sep] carries the 5
  guesses (one K2 call at Q 29), each verify round is a K2 call at Q 5,
  no q = 1 forward; checks K2 = 24 x (prime calls on K2 + verify rounds)
  and K1 = 0, the records, the route check per layer at Q 29 and Q 5,
  and that >= 0.9 of 8 envs' actions over 4 steps equal the classic
  decoder's from one cache; reads the rounds, and the steady rate, idle
  share and rounds of the speculative and the classic decoder in turns;
  then an adaptive session (``decode_spec_adaptive``) after ``prewarm``:
  its modes and switches. Then a short int8 leg (int8 cache and
  weights, 56 envs, 4 steps: K7 at Q 29 and Q 5, K9) checked the same
  way.
* ``evaluate_rl_text`` — needs ``pretrain_vision``: ``evaluate_rl.main``
  serves its checkpoint on ``fake-text-v0`` (a mission string of 18 byte
  tokens and a 32 x 32 frame an observation, one discrete action), 40
  episodes x 8 steps in one cohort; checks the weights, the route check
  at B 40, the records and the launches (the 24-token steady prime on
  K2, K1 0).
* ``stateless`` — the mem-less evaluation: ``run_episode_stateless`` at
  db1_1p2b in bf16, B 1, one episode of 8 steps with a fixed prompt over
  a 1024-token window (``WindowDecoder``: one trunk forward, K3, an
  action dim), then ``decode_batch`` over 8 of its sequences; checks K3 =
  24 x 6 x 9, the window's first-action logits against the ring decode's
  on the same sequence and the share of equal actions; reads actions/sec
  and the step time.
* ``remat``     — rematerialization at the ``train`` phase's shape
  (db1_1p2b, 2 micro-batches x 4 x 1024 tokens, dropout on):
  ``make_train_step`` with an optimizer that keeps the gradients, from the
  same weights and generator seed, with remat off and under each
  ``remat_policy`` ("full", "dots", "dots_narrow"); checks the loss
  bitwise and the generator state equal to the no-remat step, the
  gradients' cosine and norm within the train phase's limits, K3 48 a
  micro-batch under "full" and 24 under the others (the "dots" policies
  keep its outputs), K4 = K5 = 24; reads each policy's peak memory and
  median step. Then the same model as pre-LN under "dots_narrow": a
  finite loss and K3, K4 and K5 launched.
* ``serve_preln`` — the hidden-state decode: a post-LN db1_1p2b decoded
  over zero hidden memory (``decode_rl``, the prompt prime on K3) and over
  the zero ring from the same prime with the same action feeds, 8 envs:
  in bf16 layer by layer from one state (each layer's output within the
  route gate, the last layer's logits too) and end to end (read), on an
  f32 copy end to end (the logits within the route gate and >= 0.9 of
  the actions equal); then ``evaluate_rl.main``
  on a pre-LN db1_1p2b (random init), 40 lockstep HalfCheetah-geometry
  envs x 8 steps with the expert prompt: K3 24 (the prompt prime), no
  other launch, the records; one steady step timed and profiled; K3 at
  the prompt's shape (B 40) against its plain version, timed.
* ``data_parallel`` — data parallelism in a world of two processes on the
  one card (gloo: NCCL refuses two ranks on one device). db1_1p2b (bf16
  activations, f32 parameters saved by this process, no dropout, SGD at
  lr 1 after the clip) on the ``train`` phase's batch (2 x 4 x 1024, rank
  1's first row of each micro-batch cut to 512 masked positions, so the
  ranks' loss-mask counts differ): each rank takes one ``make_train_step``
  step on its 2 rows a micro-batch; checks K3 = K4 = K5 = 48 a rank, the
  ranks' parameters bitwise equal, the DP loss within the validation
  loss gate and the update's cosine and norm within the model-gradient
  gates of the one-process step on the whole batch (this process, from
  the same weights); reads each rank's step (gloo through host memory:
  not a data-parallel rate), the gradient reduce alone, its peak memory
  and the collective save. Then that step in a one-rank NCCL group: its
  reduce runs and its loss is bitwise the one-process loss. Then
  ``evaluate_rl.main`` in a new two-rank world serving the DP checkpoint
  on the ``evaluate_rl`` phase's envs, one a rank: rank 0's records are
  the shards' in rank-major order, each rank's equal a one-process run
  over its shard alone, with the same K1/K2 launches (both > 0), and
  ``results.output`` holds them once.
* ``tensor_parallel`` — tensor parallelism (tp 2, dp 1) in a world of two
  gloo processes on the one card. First every kernel of its paths at a
  rank's shapes (8 of db1_1p2b's 16 heads; the K9 trunk matrices halved)
  against its plain version, timed beside its bound and its library call:
  K1, K2 (Q 24), K6 and K7 (and K8) at B 40, K9 at 40 rows and the
  bucketed prime's 960, K3 and the backward (K4, K5) at 2 x 1024. Then
  db1_1p2b (bf16 activations, f32 parameters saved by this process, each
  rank loading its shard; no dropout, SGD lr 1 without the clip) takes
  one ``make_train_step`` step on the ``train`` phase's first
  micro-batch cut to 2 rows: K3 = K4 = K5 = 24 a rank, the tp
  checkpoint restored in one process (its slices the ranks' parameters
  bit for bit); three layers from one input and one upstream gradient,
  forward and backward through K3-K5 on the rank's heads, against the
  one-process layers: the output within the route gate, the input
  gradient within the attention-gradient gate and the parameter
  gradients within the model-gradient gates; a second step with the
  default dropout leaves the replicated parameters bitwise equal on both
  ranks; the same first step in f32 activations: the loss within the DP
  loss gate of the one-process f32 step, the update within cosine
  1 - 1e-6 and 1e-4 in norm; in bf16 the update within cosine 0.9 and 5e-2 in
  norm of the one-process bf16 update (24 random-init layers grow a
  rank's ulp-level rounding differences as far as bf16 is from f32; the
  loss is read); reads a rank's step, its collectives replayed alone
  (the gloo share) and its peak memory. Then, in the same world,
  ``evaluate_rl.main`` with ``eval.sharded_decode`` serves that
  checkpoint (40 HalfCheetah-geometry envs without the expert prompt, 4
  steps), in bf16 (K1 120, K2 24 a step a rank) and on an int8 cache
  with int8 weights (K6, K7, K9 as the plan of its ring forwards): the
  records written once; on the served weights the ring layers from one
  input (a 256-token prompt slice, the bucketed prime and the decode)
  within the route gate of one process, and on f32 copies the first
  action's logits within 1e-3 of their maximum and >= 0.9 of a 2-step
  greedy chain's actions equal to one process's (the bf16 readings
  printed beside them). The one-process steps it is held to are made once
  a run (``OneProcessReference``) and shared with ``pipeline``.
* ``pipeline``   — the GPipe pipeline (pp 2, dp 1, tp 1) in a world of two
  gloo processes on the one card, 12 of db1_1p2b's 24 layers a stage.
  First K3 and the backward (K4, K5) at a pipeline micro-batch (1 x 1024,
  16 heads) against their plain versions, timed. Then each stage loads its
  share of the weights of ``tensor_parallel``'s one-process reference and
  takes, on the same 2-row micro-batch in 2 pipeline micro-batches of one
  row (no dropout, SGD lr 1 without the clip), the f32 step: its loss
  within the DP loss gate of the one-process f32 step, its checkpoint
  restored in one process (the stages' parameters bit for bit) and the
  update read from it within cosine 1 - 1e-6 and 1e-4 in norm of the
  one-process f32 update; then from the weights again the bf16 step,
  counted: K3 = K4 = K5 = 24 a stage (12 layers x 2 micro-batches), the
  activation stage 0 sends (layer 11's output) within the route gate of
  the one-process layer 11 on the same rows, the update within cosine 0.9
  and 5e-2 in norm of the one-process bf16 update (its loss read beside
  the one-process bf16 step's own distance from f32); a second step with
  the default dropout leaves the replicated parameters bitwise equal on
  both stages. Reads a stage's step, its sends and receives replayed
  alone, its collectives replayed alone and its peak memory.
* ``tensor_parallel_nccl`` — not in the default run (four cards of one
  host): ``evaluate_rl.main`` with ``eval.sharded_decode`` over NCCL at
  tp 4, a process a card, on the same 40 envs with the expert prompt, 4
  steps, random weights: each rank's launches the plan of its ring
  forwards, the records equal across the ranks; reads actions/sec.

With ``--old-qmm SRC`` (a copy of an earlier csrc/quant_matmul.cu, e.g.
under build/), the kernels phase also times that K9 in turns with this
tree's (new, old, old, new) and its host time per call. With
``--old-rel-bwd SRC`` (a copy of an earlier
csrc/flash_rel_attention_bwd.cu with this tree's C interface, e.g. ``git
show edacf2a:bdm_db1_tpu_torch/csrc/flash_rel_attention_bwd.cu``), at the
four timed K5 shapes (the kernels phase's two, ``tensor_parallel``'s H 8
and ``pipeline``'s B 1) that source's K5 runs on this tree's delta and key
terms, its dk, dv, drk, drw and drr are held to this tree's within
BWD_REL_TOL, and the two K5s are timed in turns (old, new, new, old). With ``--old-ring SRC`` (a copy
of an earlier csrc/flash_ring_decode.cu, e.g. ``git show
9fdc92c:bdm_db1_tpu_torch/csrc/flash_ring_decode.cu``), at the timed K1,
K6, K2 and K7 cases its decode's or prime's (o, m, l) are held to this
tree's within the kernel limits and the two are timed in turns (new, old,
old, new), and its K8 (head-major scales) in turns with this tree's; its
split scratch is sized by that library's ``bdm_k1_split()`` and
``bdm_k2_split()``. With ``--old-rel-fwd SRC`` (a copy of an earlier
csrc/flash_rel_attention.cu, e.g. ``git show
9fdc92c:bdm_db1_tpu_torch/csrc/flash_rel_attention.cu``), at the two timed
K3 shapes its (out, m, l) are held to this tree's within the K3 limits
and the two are timed in turns. Both put ``old_ms`` and ``turns_ms`` on
their rows of the kernels line. ``--probe`` records how far those earlier
kernels' outputs are from this tree's without failing on it, for probe
builds with a part taken out.

The ``build`` phase also reads, from nvcc's ``-Xptxas -v`` output, the
registers, stack, spill bytes and static shared memory of K3, K4, K5 and
the two instances each of K1 and the prime (``k1_decode_kernel<bf16>``,
``<int8>``, ``k2_prime_kernel<bf16>``, ``<int8>``). The
K4/K5 records of the kernels line say what each of their times is
(``times``): ``ms`` is the kernel alone, ``train_profile_ms`` the kernel
alone in the train profile, ``call_ms`` the whole backward call.

Then it prints the card's name and power limit (nvidia-smi), one JSON line
with every kernel's numbers and its launches on the main paths (only when
``kernels`` and every main-path phase ran, as with no arguments), and as the
last line ``{"ok": true, "device": {...}}``. Any failure raises: the exit
code is then not 0 and no result line is printed. It needs one CUDA card
and imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12        # dense bf16 tensor-core peak
SPIN_CYCLES_PER_S = 1.98e9      # H100 SXM boost clock: time_ms's spin
PHASES = ("build", "kernels", "serve", "serve_int8", "serve_spec",
          "eval_loss", "train", "evaluate_rl", "pretrain", "pretrain_vision",
          "evaluate_rl_image", "evaluate_rl_text", "generate", "stateless",
          "remat", "serve_preln", "data_parallel", "tensor_parallel",
          "pipeline")
# phases of more than one card, run only when named
OPTIONAL_PHASES = ("tensor_parallel_nccl",)
MAIN_PATHS = ("serve", "serve_int8", "serve_spec", "eval_loss", "train",
              "evaluate_rl", "pretrain", "pretrain_vision",
              "evaluate_rl_image", "evaluate_rl_text", "generate",
              "stateless", "remat", "serve_preln", "data_parallel",
              "tensor_parallel", "pipeline")
SOURCES = ("flash_ring_decode", "quant_matmul", "flash_rel_attention",
           "flash_rel_attention_bwd")
# Kernel against its plain version, normalised output: max |diff| at most
# OUT_REL_TOL * max |plain output|. Both round p (times the v scale, int8)
# to bf16 per split before the PV product with the same split maxima, so
# they differ only where an exp lands on the other side of a bf16 rounding:
# a few 2^-9 of one key's weight, about 2e-4 of the largest output. A split
# whose PV is dropped or misweighted moves outputs by a share of their
# size, far above the limit. The int8 cache changes neither side's
# roundings (its values are exact in f32 and bf16), so the limit holds.
OUT_REL_TOL = 2e-3
# K9 against its plain version: max |diff| at most QMM_REL_TOL * max
# |plain|. Both sum the same exact bf16 x int8 products in f32, in another
# order (~1e-6 of the output); a wrong tile, mask or scale moves outputs by
# O(1) of their size.
QMM_REL_TOL = 1e-4


_LAST_EMIT = [time.perf_counter()]


def emit(rec: dict) -> None:
    """Print ``rec`` as one JSON line; a phase's record gets ``phase_s``,
    the wall seconds since the previous record (the phase with its
    set-up)."""
    now = time.perf_counter()
    if "phase" in rec:
        rec = dict(rec, phase_s=now - _LAST_EMIT[0])
    _LAST_EMIT[0] = now
    print(json.dumps(rec), flush=True)


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time per call of fn(i) over ``iters`` calls (CUDA
    events); i lets a caller rotate through layers or copies so no launch
    finds the previous one's bytes in L2. The card first spins for about
    50 µs a call, so the calls are all queued before the first runs and a
    call shorter than its host enqueue is not paced by the host."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(iters * 50e-6, 0.05) * SPIN_CYCLES_PER_S))
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return {"bytes": nbytes, "flops": flops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


PTXAS_KERNELS = ("k3_rel_attention_kernel", "k4_rel_bwd_dq_kernel",
                 "k5_rel_bwd_dkv_kernel", "k1_decode_kernel",
                 "k2_prime_kernel")
# the template arguments of a mangled kernel name (I<args>E after the name)
_MANGLED_ARGS = {"I13__nv_bfloat16E": "<bf16>", "IaE": "<int8>"}


def ptxas_resources(log: str) -> dict:
    """{kernel: {registers, stack, spill_stores, spill_loads, smem}} from
    nvcc's ``-Xptxas -v`` output (bytes; smem is the static shared memory
    ptxas reports, dynamic shared memory is not in it), for each entry
    function whose mangled name holds one of PTXAS_KERNELS; a template's
    instances are keyed with their argument, e.g. k2_prime_kernel<int8>."""
    out = {}
    for chunk in re.split(r"Compiling entry function", log)[1:]:
        head = chunk.split("\n", 1)[0]
        name = next((k for k in PTXAS_KERNELS if k in head), None)
        if name is None:
            continue
        rest = head[head.index(name) + len(name):]
        name += next((v for k, v in _MANGLED_ARGS.items()
                      if rest.startswith(k)), "")
        rec = {}
        m = re.search(r"Used (\d+) registers", chunk)
        if m:
            rec["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", chunk)
        if m:
            rec.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"(\d+) bytes smem", chunk)
        rec["smem"] = int(m.group(1)) if m else 0
        out[name] = rec
    return out


def phase_build() -> dict:
    from bdm_db1_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    built = cuda_build.build_libraries(SOURCES)
    rec = {"phase": "build", "seconds": time.perf_counter() - t0,
           "sources": {k: v["seconds"] for k, v in built.items()}}
    for name, info in built.items():
        # ptxas resource lines (registers, shared memory, spills)
        print(f"[nvcc {name}]\n{info['log'].strip()}", file=sys.stderr)
    rec["resources"] = {k: v for src in ("flash_rel_attention",
                                         "flash_rel_attention_bwd",
                                         "flash_ring_decode")
                        if src in built
                        for k, v in ptxas_resources(built[src]["log"]).items()}
    return rec


def _cache(gen, L, B, M, H, Dh, int8: bool):
    """(k, v, k_scale, v_scale) of a stacked ring cache from seeded bf16
    values: bf16 with no scales, or int8 with scales [L, B, M, H] made by
    quantize_kv_rows layer by layer."""
    from bdm_db1_tpu_torch.models.transformer_xl import quantize_kv_rows

    if not int8:
        k = torch.randn(L, B, M, H, Dh, device="cuda", generator=gen)
        v = torch.randn(L, B, M, H, Dh, device="cuda", generator=gen)
        return k.to(torch.bfloat16), v.to(torch.bfloat16), None, None
    out = [torch.empty(L, B, M, H, Dh, dtype=torch.int8, device="cuda")
           for _ in range(2)] + [torch.empty(L, B, M, H, device="cuda")
                                 for _ in range(2)]
    for kv in range(2):
        for layer in range(L):
            x = torch.randn(B, M, H, Dh, device="cuda", generator=gen)
            out[kv][layer], out[2 + kv][layer] = quantize_kv_rows(
                x.to(torch.bfloat16))
    return tuple(out)


def _kernel_case(fro, *, L, B, M, H, Dh, Q, layer, seed, timed, int8=False,
                 old=None):
    """One ring kernel (K1/K6 when Q is None, else K2/K7, and K8 for an
    int8 prime) against its plain version on the same inputs. Returns the
    comparison and, when timed, the times. With ``old`` (OldRing): its
    (o, m, l) held to this tree's within the same limits and, when timed,
    the two timed in turns (new, old, old, new), K8 too."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    scale = 1.0 / Dh ** 0.5
    k, v, ks, vs = _cache(gen, L, B, M, H, Dh, int8)
    nq = 1 if Q is None else Q
    qw = torch.randn(B, H, nq, Dh, device=dev, generator=gen).to(torch.bfloat16)
    bias = torch.randn(B, H, nq, M, device=dev, generator=gen) * 0.5
    bias[..., 0] = fro.NEG_INF                    # the oldest ring column
    split = fro.K1_SPLIT if Q is None else fro.K2_SPLIT
    bias[0, 1, :, split:2 * split] = fro.NEG_INF  # one all-banned split
    if Q is None:
        qw, bias = qw[:, :, 0].contiguous(), bias[:, :, 0].contiguous()
        kern, plain = fro.flash_ring_decode, fro.flash_ring_decode_plain
    else:
        kern, plain = fro.flash_ring_prime_ap, fro.flash_ring_prime_ap_plain
    sc = () if ks is None else (ks, vs)

    o, m, l = kern(k, v, qw, bias, layer, *sc, scale=scale)
    torch.cuda.synchronize()
    o_p, m_p, l_p = plain(k, v, qw, bias, layer, *sc, scale=scale,
                          block_m=split)
    torch.cuda.synchronize()
    out = o / l[..., None] if Q is not None else o / l
    out_p = o_p / l_p[..., None] if Q is not None else o_p / l_p
    out_max = float(out_p.abs().max())
    err = float((out - out_p).abs().max())
    m_err = float((m - m_p).abs().max())
    l_rel = float(((l - l_p).abs() / l_p.abs()).max())
    tol = {"out_abs": OUT_REL_TOL * out_max, "m_abs": 1e-3, "l_rel": 1e-3}
    ok = (np.isfinite([err, m_err, l_rel]).all() and err <= tol["out_abs"]
          and m_err <= tol["m_abs"] and l_rel <= tol["l_rel"])
    rec = {"shape": {"L": L, "B": B, "M": M, "H": H, "Dh": Dh, "Q": nq,
                     "layer": layer, "cache": "int8" if int8 else "bf16"},
           "max_abs_err": err, "out_plain_absmax": out_max,
           "m_abs_err": m_err, "l_rel_err": l_rel, "tol": tol, "ok": bool(ok)}
    if not ok:
        raise AssertionError(f"kernel disagrees with its plain version: {rec}")
    if old is not None:
        old_fn = old if Q is not None else old.decode
        o_o, m_o, l_o = old_fn(k, v, qw, bias, layer, *sc, scale=scale)
        torch.cuda.synchronize()
        out_o = o_o / l_o[..., None] if Q is not None else o_o / l_o
        rec["old_max_abs_err"] = float((out_o - out).abs().max())
        rec["old_m_abs_err"] = float((m_o - m).abs().max())
        rec["old_l_rel_err"] = float(((l_o - l).abs() / l.abs()).max())
        if old.checked and not (rec["old_max_abs_err"] <= tol["out_abs"]
                                and rec["old_m_abs_err"] <= tol["m_abs"]
                                and rec["old_l_rel_err"] <= tol["l_rel"]):
            raise AssertionError(f"the old ring kernel disagrees with this "
                                 f"tree's: {rec}")
    k8 = None
    if int8 and Q is not None:
        # K8: the same prime with the scales head-major [L, B, H, M] must
        # give K7's outputs exactly (one kernel, another scale stride)
        ks_t, vs_t = ks.transpose(2, 3).contiguous(), vs.transpose(2, 3).contiguous()
        got = fro.flash_ring_prime(k, v, qw, bias, layer, ks_t, vs_t,
                                   scale=scale)
        torch.cuda.synchronize()
        rec["k8_equals_k7"] = all(torch.equal(a, b)
                                  for a, b in zip(got, (o, m, l)))
        if not rec["k8_equals_k7"]:
            raise AssertionError("K8 on transposed scales differs from K7")
        o8, _, l8 = got
        rec["k8_max_abs_err"] = float((o8 / l8[..., None] - out_p).abs().max())

        def k8(i):
            return fro.flash_ring_prime(k, v, qw, bias, i % L, ks_t, vs_t,
                                        scale=scale)
    if timed:
        elem = 1 if int8 else 2
        cache_bytes = 2 * B * M * H * Dh * elem + (2 * B * M * H * 4 if int8
                                                   else 0)
        io_bytes = (qw.numel() * 2 + bias.numel() * 4
                    + B * H * nq * Dh * 4 + 2 * B * H * nq * 4)
        rec.update(bound(cache_bytes + io_bytes, 2 * 2 * B * H * nq * M * Dh))
        def new_fn(i):
            return kern(k, v, qw, bias, i % L, *sc, scale=scale)

        if old is None:
            rec["ms"] = time_ms(new_fn, iters=48)
        else:
            def old_fn(i):
                return (old if Q is not None else old.decode)(
                    k, v, qw, bias, i % L, *sc, scale=scale)

            times = [time_ms(f, iters=48)
                     for f in (new_fn, old_fn, old_fn, new_fn)]
            rec["ms"] = float(np.mean(times[::3]))
            rec["old_ms"] = float(np.mean(times[1:3]))
            rec["turns_ms"] = times
        if k8 is not None and old is None:
            rec["k8_ms"] = time_ms(k8, iters=48)
        elif k8 is not None:
            def old_k8(i):
                return old(k, v, qw, bias, i % L, ks_t, vs_t, scale=scale,
                           head_major=True)

            times = [time_ms(f, iters=48) for f in (k8, old_k8, old_k8, k8)]
            rec["k8_ms"] = float(np.mean(times[::3]))
            rec["k8_old_ms"] = float(np.mean(times[1:3]))
            rec["k8_turns_ms"] = times
        rec["plain_ms"] = time_ms(lambda i: plain(
            k, v, qw, bias, i % L, *sc,
            scale=scale, block_m=split), iters=6, warmup=1)
        # yardstick only: one PyTorch call computing the normalised output
        # of the same attention (the port never calls it); an int8 cache is
        # dequantized to bf16 beforehand, outside the timing, for 4 layers
        qs = (qw if Q is not None else qw[:, :, None])
        mask = (bias if Q is not None else bias[:, :, None]).to(torch.bfloat16)
        if int8:
            from bdm_db1_tpu_torch.models.transformer_xl import dequantize_kv

            lib_layers = [(dequantize_kv(k[j], ks[j], torch.bfloat16),
                           dequantize_kv(v[j], vs[j], torch.bfloat16))
                          for j in range(min(4, L))]
        else:
            lib_layers = [(k[j], v[j]) for j in range(L)]

        def lib(i):
            kl, vl = lib_layers[i % len(lib_layers)]
            return F.scaled_dot_product_attention(
                qs, kl.permute(0, 2, 1, 3), vl.permute(0, 2, 1, 3),
                attn_mask=mask, scale=scale)

        rec["library_ms"] = time_ms(lib, iters=12, warmup=2)
        rec["library"] = "F.scaled_dot_product_attention" + (
            " over the dequantized bf16 cache" if int8 else "")
    return rec


# the trunk matrices (K, N) of db1_1p2b: qkv_net, o_net, CoreNet.0, .2
TRUNK = {"qkv_net": (2048, 6144), "o_net": (2048, 2048),
         "CoreNet.0": (2048, 8192), "CoreNet.2": (4096, 2048)}
# K9's rows in the int8 serve: 56 envs x q = 1, 19 (the steady prime
# before geometry buckets), 24 (its bucket width), 26 (the prompt's tail
# slice before buckets), 32 (its bucket width), 256 (a prompt slice)
QMM_ROWS = (56, 1064, 1344, 1456, 1792, 14336)
# K9's untimed edge shapes: rows around the one-tile limit (64) and past
# it, ragged N, a K tail of half a step (96, 4128 = 64.5 x 64); 56 x 4128
# x 2056 splits K 4 ways with a shorter last split
QMM_EDGE = [(R, K, N) for R in (1, 8, 57, 64, 65, 200) for K in (96, 4128)
            for N in (200, 2056)]


def _build_copy(src: str):
    """nvcc (the port's flags) on a copy of an earlier CUDA source, next to
    it: (the loaded library, nvcc's output). The classes below that wrap
    such a copy hold its outputs to this tree's unless ``checked`` is False
    (--probe: probe builds with a part taken out)."""
    import ctypes
    import os
    from pathlib import Path

    from bdm_db1_tpu_torch.ops import cuda_build

    src = Path(src).resolve()
    out = src.with_suffix(".so")
    log = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o",
                          str(out), str(src)], capture_output=True, text=True)
    if log.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{log.stdout}"
                           f"{log.stderr}")
    return ctypes.CDLL(os.fspath(out)), log.stdout + log.stderr


class OldRing:
    """An earlier K2/K7 prime and K1/K6 decode with this tree's C interface
    (``bdm_flash_ring_prime``, ``bdm_flash_ring_decode``), built from a copy
    of its csrc/flash_ring_decode.cu given by --old-ring and called as its
    wrapper called them, with split scratch sized by that library's
    ``bdm_k2_split()`` and ``bdm_k1_split()`` (scales [L, B, M, H], or
    [L, B, H, M] with ``head_major``, K8): timed in turns with this tree's
    kernels on the same card. Not part of the port."""

    def __init__(self, src: str, checked: bool = True):
        import ctypes

        lib, log = _build_copy(src)
        self.resources = ptxas_resources(log)
        self.checked = checked
        P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.bdm_flash_ring_prime.argtypes = [P] * 12 + [I] * 6 + [Fl, I, P]
        lib.bdm_flash_ring_prime.restype = I
        lib.bdm_flash_ring_decode.argtypes = [P] * 12 + [I] * 4 + [Fl, I, P]
        lib.bdm_flash_ring_decode.restype = I
        lib.bdm_k2_split.restype = I
        lib.bdm_k1_split.restype = I
        self.split = lib.bdm_k2_split()
        self.k1_split = lib.bdm_k1_split()
        self.lib = lib

    def decode(self, k, v, qw, bias, layer, ks=None, vs=None, *, scale):
        """The old K1/K6: qw [B, H, Dh] -> (o [B, H, Dh], m, l [B, H, 1])."""
        from bdm_db1_tpu_torch.ops import flash_ring_decode as fro

        _, B, M, H, Dh = k.shape
        dev = k.device
        S = -(-M // self.k1_split)
        f32 = dict(device=dev, dtype=torch.float32)
        parts = (torch.empty(B, S, H, Dh, **f32), torch.empty(B, S, H, **f32),
                 torch.empty(B, S, H, **f32))
        outs = (torch.empty(B, H, Dh, **f32), torch.empty(B, H, 1, **f32),
                torch.empty(B, H, 1, **f32))
        rc = self.lib.bdm_flash_ring_decode(
            k.data_ptr(), v.data_ptr(), None if ks is None else ks.data_ptr(),
            None if vs is None else vs.data_ptr(), qw.data_ptr(),
            bias.data_ptr(), *(t.data_ptr() for t in parts + outs), layer, B,
            M, H, fro._bf16_scale(scale), dev.index or 0,
            torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            raise RuntimeError(f"old decode launch failed ({rc})")
        return outs

    def __call__(self, k, v, qw, bias, layer, ks=None, vs=None, *, scale,
                 head_major=False):
        from bdm_db1_tpu_torch.ops import flash_ring_decode as fro

        _, B, M, H, Dh = k.shape
        Q = qw.shape[2]
        dev = k.device
        S = -(-M // self.split)
        f32 = dict(device=dev, dtype=torch.float32)
        parts = (torch.empty(B, S, H, Q, Dh, **f32),
                 torch.empty(B, S, H, Q, **f32),
                 torch.empty(B, S, H, Q, **f32))
        outs = (torch.empty(B, H, Q, Dh, **f32), torch.empty(B, H, Q, **f32),
                torch.empty(B, H, Q, **f32))
        rc = self.lib.bdm_flash_ring_prime(
            k.data_ptr(), v.data_ptr(), None if ks is None else ks.data_ptr(),
            None if vs is None else vs.data_ptr(), qw.data_ptr(),
            bias.data_ptr(), *(t.data_ptr() for t in parts + outs), layer, B,
            M, H, Q, 1 if head_major else H, fro._bf16_scale(scale),
            dev.index or 0,
            torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            raise RuntimeError(f"old prime launch failed ({rc})")
        return outs


class OldRelFwd:
    """An earlier K3 with this tree's C interface
    (``bdm_flash_rel_attention``: the key terms, then the kernel), built
    from a copy of its csrc/flash_rel_attention.cu given by --old-rel-fwd
    and called as its wrapper called it: held to this tree's K3 and timed
    in turns with it on the same card. Not part of the port."""

    def __init__(self, src: str, checked: bool = True):
        import ctypes

        lib, log = _build_copy(src)
        self.resources = ptxas_resources(log)
        self.checked = checked
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.bdm_flash_rel_attention.argtypes = (
            [P] * 11 + [LL] * 6 + [I] * 6 + [ctypes.c_float, I, P])
        lib.bdm_flash_rel_attention.restype = I
        self.lib = lib

    def __call__(self, q, k, v, rk, r_w_bias, r_r_bias, *, mem_len,
                 same_length, scale):
        dev = q.device
        B, qlen, H, Dh = q.shape
        klen = k.shape[1]
        rw = r_w_bias.float().contiguous()
        rr = r_r_bias.float().contiguous()
        f32 = dict(dtype=torch.float32, device=dev)
        out = torch.empty(B, qlen, H, Dh, dtype=torch.bfloat16, device=dev)
        m = torch.empty(B, H, qlen, **f32)
        l = torch.empty(B, H, qlen, **f32)
        rwk = torch.empty(B * H * klen, **f32)
        rrk = torch.empty(H * klen, **f32)
        rc = self.lib.bdm_flash_rel_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), rk.data_ptr(),
            rw.data_ptr(), rr.data_ptr(), out.data_ptr(), m.data_ptr(),
            l.data_ptr(), rwk.data_ptr(), rrk.data_ptr(), q.stride(0),
            q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
            B, H, qlen, klen, mem_len, int(same_length), scale,
            dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            raise RuntimeError(f"old K3 launch failed ({rc})")
        return out, m, l


class OldQmm:
    """An earlier K9 kernel with the 9-argument C interface (the wmma,
    cp.async-ring one), built from a copy of its source given by
    --old-qmm and called as its wrapper called it: timed in turns with the
    kernel of this tree on the same card. Not part of the port."""

    def __init__(self, src: str):
        import ctypes

        self.lib, _ = _build_copy(src)
        P, I = ctypes.c_void_p, ctypes.c_int
        self.lib.bdm_quant_matmul.argtypes = [P] * 4 + [I] * 4 + [P]
        self.lib.bdm_quant_matmul.restype = I

    def __call__(self, x, w_q, scale):
        from bdm_db1_tpu_torch.ops.cuda_build import check_operand

        R, K = x.shape
        N = w_q.shape[0]
        dev = x.device
        check_operand("x", x, (R, K), torch.bfloat16, dev)
        check_operand("w_q", w_q, (N, K), torch.int8, dev)
        check_operand("scale", scale, (N,), torch.float32, dev)
        y = torch.empty(R, N, device=dev, dtype=torch.float32)
        rc = self.lib.bdm_quant_matmul(
            x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), y.data_ptr(), R,
            K, N, dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            raise RuntimeError(f"old K9 launch failed ({rc})")
        return y


class OldRelBwd:
    """An earlier K5 with this tree's C interface (``bdm_rel_bwd(which,
    ...)``: the preparation, K4 and K5 as separate steps), built from a copy
    of its csrc/flash_rel_attention_bwd.cu given by --old-rel-bwd. ``dkv``
    runs its K5 alone on the operands of ``_bwd_operands`` after this
    tree's preparation (the same delta and key terms). Timed in turns with
    this tree's K5 on the same card. Not part of the port."""

    def __init__(self, src: str, checked: bool = True):
        import ctypes

        lib, log = _build_copy(src)
        self.resources = ptxas_resources(log)
        self.checked = checked
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.bdm_rel_bwd.argtypes = (
            [I] + [P] * 19 + [LL] * 6 + [I] * 6 + [ctypes.c_float, I, P])
        lib.bdm_rel_bwd.restype = I
        self.lib = lib

    def dkv(self, t, mem_len, same_length, scale):
        from bdm_db1_tpu_torch.ops.flash_rel_attention import _BWD_PTRS

        q, k, v = t["q"], t["k"], t["v"]
        B, qlen, H, _ = q.shape
        dev = q.device
        rc = self.lib.bdm_rel_bwd(
            2, *[0 if t.get(n) is None else t[n].data_ptr()
                 for n in _BWD_PTRS],
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
            v.stride(1), B, H, qlen, k.shape[1], mem_len, int(same_length),
            scale, dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            raise RuntimeError(f"old K5 launch failed ({rc})")


def _qmm_case(qm, *, R, K, N, seed, timed, old=None):
    """K9 against its plain version on one weight made by quantize_weight
    from seeded values, with its plan; at 56, 1064 and 1344 rows two calls
    must agree bit for bit. When timed, its time, bound, plain time and the time
    of F.linear on the pre-dequantized bf16 weight; with ``old``, the old
    kernel and this one timed in turns (new, old, old, new)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    w_q, s = qm.quantize_weight(
        torch.randn(N, K, device="cuda", generator=gen) * 0.02)
    x = torch.randn(R, K, device="cuda", generator=gen).to(torch.bfloat16)
    y = qm.quant_matmul(x, w_q, s)
    torch.cuda.synchronize()
    y_p = qm.quant_matmul_plain(x, w_q, s)
    torch.cuda.synchronize()
    err = float((y - y_p).abs().max())
    ymax = float(y_p.abs().max())
    plan = qm.plan_quant_matmul(R, K, N)
    rec = {"shape": {"R": R, "K": K, "N": N}, "max_abs_err": err,
           "out_plain_absmax": ymax, "tol": QMM_REL_TOL * ymax,
           "plan": {"bn": plan.bn, "bm": plan.bm, "split": plan.split,
                    "kps": plan.kps, "nk": plan.nk, "ctas": plan.ctas},
           "ok": bool(np.isfinite(err) and err <= QMM_REL_TOL * ymax)}
    if R in (56, 1064, 1344):
        rec["bitwise_repeat"] = bool(torch.equal(y, qm.quant_matmul(x, w_q,
                                                                    s)))
        rec["ok"] = rec["ok"] and rec["bitwise_repeat"]
    if not rec["ok"]:
        raise AssertionError(f"K9 disagrees with its plain version or "
                             f"with itself: {rec}")
    if timed:
        rec.update(bound(R * K * 2 + N * K + N * 4 + R * N * 4,
                         2 * R * K * N))
        # >= 128 MB of weights between two reads of one copy (50 MB L2)
        n = max(1, min(16, -(-(1 << 27) // (N * K))))
        wqs = [w_q] + [w_q.clone() for _ in range(n - 1)]
        iters = 200 if R <= 64 else 50 if R <= 2048 else 10
        turns = [qm.quant_matmul] + ([old, old, qm.quant_matmul] if old
                                     else [])
        times = [time_ms(lambda i, f=f: f(x, wqs[i % n], s), iters=iters)
                 for f in turns]
        rec["ms"] = float(np.mean(times[::3]))
        if old:
            y_o = old(x, w_q, s)
            torch.cuda.synchronize()
            rec["old_max_abs_err"] = float((y_o - y_p).abs().max())
            rec["old_ms"] = float(np.mean(times[1:3]))
            rec["turns_ms"] = times
        rec["plain_ms"] = time_ms(lambda i: qm.quant_matmul_plain(
            x, wqs[i % n], s), iters=3, warmup=1)
        w_bf = [(c.float() * s[:, None]).to(torch.bfloat16) for c in wqs]
        rec["library_ms"] = time_ms(lambda i: F.linear(x, w_bf[i % n]),
                                    iters=iters)
        rec["library"] = "F.linear, bf16 weight dequantized beforehand"
    return rec


def _qmm_host_us(qm, old=None, calls: int = 1000) -> dict:
    """Host time a K9 call takes to enqueue (wrapper, plan, ctypes,
    launch), µs: ``calls`` calls at 56 x 2048 x 2048 without a sync (the
    card takes less time a call than the host, so the host clock reads the
    enqueue); with ``old``, the old wrapper's the same way, in three rounds
    of turns (new, old, old, new): the host is shared and noisy."""
    gen = torch.Generator(device="cuda").manual_seed(70)
    w_q, s = qm.quantize_weight(
        torch.randn(2048, 2048, device="cuda", generator=gen) * 0.02)
    x = torch.randn(56, 2048, device="cuda", generator=gen).to(torch.bfloat16)
    out = {}
    new = ("new", qm.quant_matmul)
    turns = [new, ("old", old), ("old", old), new] * 3 if old else [new]
    for name, f in turns:
        for _ in range(10):
            f(x, w_q, s)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            f(x, w_q, s)
        out.setdefault(name, []).append(
            (time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return {"shape": {"R": 56, "K": 2048, "N": 2048}, "calls": calls,
            **{f"{k}_us": v for k, v in out.items()},
            **{f"{k}_us_median": float(np.median(v)) for k, v in out.items()}}


def _w8a8_check(qm) -> list:
    """W8A8's int8 x int8 -> int32 product (torch._int_mm) against the
    exact integer product (f64 on the card: |acc| <= K * 127^2 < 2^53)."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    out = []
    for R, K, N in ((56, 2048, 6144), (1064, 4096, 2048), (5, 96, 40)):
        xq = torch.randint(-127, 128, (R, K), device="cuda", generator=gen,
                           dtype=torch.int8)
        wq = torch.randint(-127, 128, (N, K), device="cuda", generator=gen,
                           dtype=torch.int8)
        acc = qm.int8_matmul(xq, wq)
        exact = xq.double() @ wq.double().t()
        ok = acc.dtype == torch.int32 and torch.equal(acc.double(), exact)
        out.append({"shape": [R, K, N], "exact": bool(ok)})
        if not ok:
            raise AssertionError(f"W8A8 int32 product is not exact: {out}")
    return out


# K3 against its plain version. out is bf16 on both sides: where the two
# f32 results straddle a bf16 rounding boundary they differ by one ulp of
# the element (at most 2^-7 of it), so each element may differ by that plus
# OUT_REL_TOL * max |plain|, the ring kernels' limit for the softmax itself
# (p rounded to bf16 per key tile with the running max against once with
# the final max). The f32 row stats hold the mask: one key wrongly in or out
# of a row moves l by ~1/n of it (>= 1e-3 at n <= 1024) and m by a score,
# while both sides sum the same f32 products in another order (~1e-6).
K3_M_ABS_TOL = 1e-4
K3_L_REL_TOL = 1e-4
# K4/K5 against their plain version: each gradient's max |diff| at most
# BWD_REL_TOL of its largest value. dq, dk, dv and drk are bf16 on both
# sides (the kernels round p and dS to bf16 for the tensor-core products,
# the plain version does not), so they differ by about one bf16 ulp of an
# element, at most 2^-7 = 7.8e-3 of the largest; drk's f32 atomics add in
# another order every run. drw and drr are f32 sums of the same f32 terms
# in another order. Readings on an H100 80GB HBM3 (700 W) over the three
# shapes: dq 5.3e-3, dk 4.1e-3, dv 5.1e-3, drk 7.7e-3, drw 1.3e-6, drr
# 1.4e-6. A wrong mask, shift, scale or band row moves a gradient by O(1)
# of its size.
BWD_REL_TOL = {"dq": 2e-2, "dk": 2e-2, "dv": 2e-2, "drk": 2e-2,
               "drw": 1e-4, "drr": 1e-4}


def _rel_case(fra, *, B, qlen, klen, mem_len, same_length, seed, timed,
              old=None, H=16):
    """K3 on q, k, v sliced from one fused [B, klen, 3 * H * Dh] projection
    (as the trunk feeds it, through its strides) against its plain version:
    (out, m, l); when timed, its time, bound, plain time and the time of
    F.scaled_dot_product_attention on the same function. With ``old``
    (OldRelFwd): its (out, m, l) held to this tree's within the same limits
    and, when timed, the two timed in turns (new, old, old, new)."""
    from bdm_db1_tpu_torch.ops.attention import (
        causal_mask, rel_shift_sliced, same_length_mask,
    )

    Dh = 128
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(B, klen, 3 * H * Dh, device="cuda",
                      generator=gen).to(torch.bfloat16)
    q, k, v = qkv.split(H * Dh, dim=-1)
    q = q[:, -qlen:].unflatten(-1, (H, Dh))
    k, v = k.unflatten(-1, (H, Dh)), v.unflatten(-1, (H, Dh))
    rk = torch.randn(klen, H, Dh, device="cuda",
                     generator=gen).to(torch.bfloat16)
    rw = torch.randn(H, Dh, device="cuda", generator=gen) * 0.1
    rr = torch.randn(H, Dh, device="cuda", generator=gen) * 0.1
    kw = dict(mem_len=mem_len, same_length=same_length, scale=1.0 / Dh ** 0.5)
    args = (q, k, v, rk, rw, rr)
    out, (m, l) = fra.flash_rel_attention(*args, with_stats=True, **kw)
    torch.cuda.synchronize()
    out_p, m_p, l_p = fra.flash_rel_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    rec = {"shape": {"B": B, "qlen": qlen, "klen": klen, "H": H, "Dh": Dh,
                     "mem_len": mem_len, "same_length": same_length},
           **_k3_errors((out, m, l), (out_p, m_p, l_p)),
           "tol": {"out": "2^-7 |plain| + %g max|plain|" % OUT_REL_TOL,
                   "m_abs": K3_M_ABS_TOL, "l_rel": K3_L_REL_TOL}}
    rec["ok"] = _k3_ok(rec)
    if not rec["ok"]:
        raise AssertionError(f"K3 disagrees with its plain version: {rec}")
    if old is not None:
        got = old(*args, **kw)
        torch.cuda.synchronize()
        rec["old"] = _k3_errors(got, (out, m, l))
        if old.checked and not _k3_ok(rec["old"]):
            raise AssertionError(f"the old K3 disagrees with this tree's: "
                                 f"{rec['old']}")
    if timed:
        banned = (same_length_mask(qlen, klen, mem_len, device="cuda")
                  if same_length else causal_mask(qlen, klen, device="cuda"))
        pairs = int((~banned).sum()) * B * H
        # q, k, v, o and rk once each in bf16, the f32 stats and biases
        nbytes = 2 * (2 * B * qlen + 2 * B * klen + klen) * H * Dh \
            + 4 * (2 * B * H * qlen + 2 * H * Dh)
        rec.update(bound(nbytes, 3 * 2 * Dh * pairs))
        rec["unbanned_pairs"] = pairs

        def new_fn(i):
            return fra.flash_rel_attention(*args, **kw)

        if old is None:
            rec["ms"] = time_ms(new_fn, iters=20)
        else:
            def old_fn(i):
                return old(*args, **kw)

            times = [time_ms(f, iters=20)
                     for f in (new_fn, old_fn, old_fn, new_fn)]
            rec["ms"] = float(np.mean(times[::3]))
            rec["old_ms"] = float(np.mean(times[1:3]))
            rec["turns_ms"] = times
        rec["plain_ms"] = time_ms(lambda i: fra.flash_rel_attention_plain(
            *args, **kw), iters=3, warmup=1)
        # yardstick only (the port never calls it): SDPA of (q + r_w) over
        # k, v with the scaled BD term and -inf at banned positions as its
        # float mask, built beforehand outside the timing, so the library
        # time leaves out the BD product and the mask that K3 computes
        qw = (q.float() + rw).to(torch.bfloat16).transpose(1, 2)
        bd = torch.einsum("bihd,jhd->bhij", q.float() + rr, rk.float())
        mask = torch.where(banned, float("-inf"), rel_shift_sliced(bd)
                           * kw["scale"]).to(torch.bfloat16)
        del bd
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)
        rec["library_ms"] = time_ms(lambda i: F.scaled_dot_product_attention(
            qw, kt, vt, attn_mask=mask, scale=kw["scale"]), iters=10)
        rec["library"] = ("F.scaled_dot_product_attention of q + r_w with "
                          "the scaled BD term as a bf16 mask built "
                          "beforehand (undercounts the whole function)")
    return rec


def _k3_errors(got, ref) -> dict:
    """(out, m, l) of a K3 against a reference's: out's largest difference
    and its excess over the limit 2^-7 |ref| + OUT_REL_TOL max |ref|, m's
    largest absolute and l's largest relative difference."""
    (out, m, l), (out_r, m_r, l_r) = got, ref
    diff = (out.float() - out_r.float()).abs()
    out_max = float(out_r.float().abs().max())
    return {"max_abs_err": float(diff.max()), "out_plain_absmax": out_max,
            "err_over_limit_max": float((diff - 2.0 ** -7 * out_r.float().abs()
                                         - OUT_REL_TOL * out_max).max()),
            "m_abs_err": float((m - m_r).abs().max()),
            "l_rel_err": float(((l - l_r).abs() / l_r.abs()).max())}


def _k3_ok(e: dict) -> bool:
    return bool(np.isfinite([e["max_abs_err"], e["m_abs_err"],
                             e["l_rel_err"]]).all()
                and e["err_over_limit_max"] <= 0
                and e["m_abs_err"] <= K3_M_ABS_TOL
                and e["l_rel_err"] <= K3_L_REL_TOL)


GRAD_NAMES = ("dq", "dk", "dv", "drk", "drw", "drr")
# The preparation's delta against its plain version: max |diff| at most
# DELTA_REL_TOL * max |plain|. Both sum the same 128 exact products of bf16
# values in f32, in another order (~1e-7 of the largest row); a wrong row,
# head or operand moves delta by O(1) of its size.
DELTA_REL_TOL = 1e-5


def _old_k5_turns(fra, old, t, pos) -> dict:
    """An earlier K5 (OldRelBwd) against this tree's on the operands ``t``
    of ``_bwd_operands`` after this tree's preparation (the same delta and
    key terms), each into outputs of its own with zeroed sums: dk, dv, drk,
    drw and drr each within BWD_REL_TOL of this tree's largest value; then
    the two K5s alone timed in turns (old, new, new, old)."""
    outs = {}
    for name, run in (("new", lambda u: fra._bwd_step("dkv", u, *pos)),
                      ("old", lambda u: old.dkv(u, *pos))):
        u = dict(t, dk=torch.empty_like(t["dk"]), dv=torch.empty_like(t["dv"]),
                 **{n: torch.zeros_like(t[n]) for n in ("drk", "drw", "drr")})
        run(u)
        outs[name] = u
    torch.cuda.synchronize()
    rel = {n: float((outs["old"][n].float() - outs["new"][n].float()).abs()
                    .max() / outs["new"][n].float().abs().max())
           for n in GRAD_NAMES[1:]}
    if old.checked and not all(np.isfinite(v) and v <= BWD_REL_TOL[n]
                               for n, v in rel.items()):
        raise AssertionError(f"the old K5 disagrees with this tree's: {rel}")
    new_u, old_u = outs["new"], outs["old"]
    times = [time_ms(f, iters=20) for f in (
        lambda i: old.dkv(old_u, *pos),
        lambda i: fra._bwd_step("dkv", new_u, *pos),
        lambda i: fra._bwd_step("dkv", new_u, *pos),
        lambda i: old.dkv(old_u, *pos))]
    return {"old_vs_new_rel_err": rel, "ms": float(np.mean(times[1:3])),
            "old_ms": float(np.mean(times[::3])), "turns_ms": times}


def _rel_bwd_case(fra, *, B, qlen, klen, mem_len, same_length, seed, timed,
                  old=None, H=16):
    """The backward (the preparation, K4 and K5) on K3's inputs (q, k, v
    sliced from one fused projection), K3's (out, m, l) and a seeded
    upstream gradient, against its plain version: the six gradients, each
    within BWD_REL_TOL of its largest value, and the preparation's delta
    within DELTA_REL_TOL. When timed: K4 and K5 each alone (CUDA events
    around bare launches on one preparation's delta and key terms), the
    preparation, the whole ``flash_rel_attention_bwd`` call, each kernel's
    bound, the plain backward and the SDPA backward as a yardstick. With
    ``old`` (OldRelBwd), when timed: its K5 held to this tree's and the two
    timed in turns (``_old_k5_turns``)."""
    from bdm_db1_tpu_torch.ops.attention import rel_shift_sliced

    Dh = 128
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(B, klen, 3 * H * Dh, device="cuda",
                      generator=gen).to(torch.bfloat16)
    q, k, v = qkv.split(H * Dh, dim=-1)
    q = q[:, -qlen:].unflatten(-1, (H, Dh))
    k, v = k.unflatten(-1, (H, Dh)), v.unflatten(-1, (H, Dh))
    rk = torch.randn(klen, H, Dh, device="cuda",
                     generator=gen).to(torch.bfloat16)
    rw = torch.randn(H, Dh, device="cuda", generator=gen) * 0.1
    rr = torch.randn(H, Dh, device="cuda", generator=gen) * 0.1
    dout = torch.randn(B, qlen, H, Dh, device="cuda",
                       generator=gen).to(torch.bfloat16)
    kw = dict(mem_len=mem_len, same_length=same_length, scale=1.0 / Dh ** 0.5)
    args = (q, k, v, rk, rw, rr)
    with torch.no_grad():
        out, (m, l) = fra.flash_rel_attention(*args, with_stats=True, **kw)
    saved = args + (out, m, l, dout)
    pos = (mem_len, same_length, kw["scale"])
    got = fra.flash_rel_attention_bwd(*saved, **kw)
    torch.cuda.synchronize()
    ref = fra.flash_rel_attention_bwd_plain(*saved, **kw)
    torch.cuda.synchronize()
    rel, abs_err = {}, {}
    for name, a, b in zip(GRAD_NAMES, got, ref):
        abs_err[name] = float((a.float() - b.float()).abs().max())
        rel[name] = abs_err[name] / float(b.float().abs().max())
    del ref
    t = fra._bwd_operands(*saved)
    fra._bwd_step("prep", t, *pos)
    delta_ref = fra.bwd_delta_plain(out, dout)
    delta_rel = float((t["delta"] - delta_ref).abs().max()
                      / delta_ref.abs().max())
    ok = (all(np.isfinite(rel[n]) and rel[n] <= BWD_REL_TOL[n]
              for n in GRAD_NAMES)
          and np.isfinite(delta_rel) and delta_rel <= DELTA_REL_TOL)
    rec = {"shape": {"B": B, "qlen": qlen, "klen": klen, "H": H, "Dh": Dh,
                     "mem_len": mem_len, "same_length": same_length},
           "rel_err": rel, "abs_err": abs_err, "tol": BWD_REL_TOL,
           "delta_rel_err": delta_rel, "delta_tol": DELTA_REL_TOL,
           "ok": bool(ok)}
    if not ok:
        raise AssertionError(f"K4/K5 disagree with their plain version: {rec}")
    if timed:
        banned = fra._banned(qlen, klen, mem_len, same_length, "cuda")
        pairs = int((~banned).sum()) * B * H
        rows_q, rows_k = B * qlen * H * Dh, B * klen * H * Dh
        stats = 3 * 4 * B * H * qlen                   # m, l, delta
        ins = 2 * (2 * rows_q + 2 * rows_k + klen * H * Dh) + stats \
            + 2 * 4 * H * Dh
        rec["dq"] = bound(ins + 2 * rows_q, 5 * 2 * Dh * pairs)
        rec["dkv"] = bound(ins + 2 * 2 * rows_k + 4 * klen * H * Dh
                           + 2 * 4 * H * Dh, 6 * 2 * Dh * pairs)
        rec["unbanned_pairs"] = pairs
        # the kernels alone, on the delta and key terms made above (K5 adds
        # into the same sums on every call: its time does not depend on them)
        for which in ("dq", "dkv"):
            rec[which]["ms"] = time_ms(
                lambda i, w=which: fra._bwd_step(w, t, *pos), iters=20)
        rec["prep_ms"] = time_ms(lambda i: fra._bwd_step("prep", t, *pos),
                                 iters=20)
        if old is not None:
            rec["dkv"].update(_old_k5_turns(fra, old, t, pos))
        rec["call_ms"] = time_ms(
            lambda i: fra.flash_rel_attention_bwd(*saved, **kw), iters=10)
        rec["plain_ms"] = time_ms(lambda i: fra.flash_rel_attention_bwd_plain(
            *saved, **kw), iters=2, warmup=1)
        # yardstick only (the port never calls it): the backward of SDPA of
        # (q + r_w) over k, v with the scaled BD term and -inf as a float
        # mask built beforehand, over torch.autograd.grad with the forward
        # done first. One number for K4 + K5; it leaves out the BD band
        # gradients (dq_bd, drk, drr), so it undercounts the function.
        qw = (q.float() + rw).to(torch.bfloat16).transpose(1, 2) \
            .detach().requires_grad_(True)
        kt = k.transpose(1, 2).detach().requires_grad_(True)
        vt = v.transpose(1, 2).detach().requires_grad_(True)
        with torch.no_grad():
            bd = torch.einsum("bihd,jhd->bhij", q.float() + rr, rk.float())
            mask = torch.where(banned, float("-inf"), rel_shift_sliced(bd)
                               * kw["scale"]).to(torch.bfloat16)
            del bd
        o = F.scaled_dot_product_attention(qw, kt, vt, attn_mask=mask,
                                           scale=kw["scale"])
        go = dout.transpose(1, 2)
        rec["library_ms"] = time_ms(lambda i: torch.autograd.grad(
            o, (qw, kt, vt), go, retain_graph=True), iters=10)
        rec["library"] = ("backward of F.scaled_dot_product_attention of q + "
                          "r_w with the scaled BD term as a bf16 mask: K4 + "
                          "K5 together, without the BD gradients "
                          "(undercounts the function)")
    return rec


def phase_kernels(old_qmm=None, old_bwd=None, old_ring=None,
                  old_rel_fwd=None, probe=False) -> dict:
    from bdm_db1_tpu_torch.ops import flash_rel_attention as fra
    from bdm_db1_tpu_torch.ops import flash_ring_decode as fro
    from bdm_db1_tpu_torch.ops import quant_matmul as qm

    full = dict(L=24, B=40, M=1024, H=16, Dh=128, layer=17)
    full8 = dict(full, B=56, int8=True)
    ragged = dict(L=3, B=3, M=200, H=4, Dh=128, layer=2)
    ragged8 = dict(ragged, int8=True)
    # M not a multiple of 4 (the bias rows are then not 16-byte aligned),
    # both of the prime's row tiles at Q 17, more (head, row) pairs than SMs
    odd = dict(L=2, B=48, M=201, H=4, Dh=128, layer=1)
    # the pretrain phase's rollouts: one env, so B 1
    one = dict(full, B=1)
    ring = OldRing(old_ring, not probe) if old_ring else None
    cases = {
        "flash_ring_decode": [
            _kernel_case(fro, Q=None, seed=1, timed=True, old=ring, **full),
            _kernel_case(fro, Q=None, seed=2, timed=False, **ragged),
            _kernel_case(fro, Q=None, seed=7, timed=False, **odd),
            _kernel_case(fro, Q=None, seed=8, timed=False, **one),
            # the caption, VQA and text generators' token steps at B 8
            _kernel_case(fro, Q=None, seed=23, timed=True,
                         **dict(full, B=GEN_B))],
        "flash_ring_prime_ap": [
            _kernel_case(fro, Q=19, seed=3, timed=True, old=ring, **full),
            _kernel_case(fro, Q=26, seed=4, timed=True, old=ring, **full),
            _kernel_case(fro, Q=5, seed=5, timed=False, **ragged),
            _kernel_case(fro, Q=17, seed=6, timed=False, **odd),
            _kernel_case(fro, Q=19, seed=9, timed=False, **one),
            _kernel_case(fro, Q=26, seed=10, timed=False, **one),
            # the image rollouts' [action || 25 patch slots || sep] prime
            _kernel_case(fro, Q=27, seed=18, timed=False, **full),
            # the bucket widths of the serve's 19-token steady prime and of
            # the image serve's 27-token one
            _kernel_case(fro, Q=24, seed=21, timed=True, **full),
            _kernel_case(fro, Q=32, seed=22, timed=True, **full),
            # speculative decode: the steady prime with its guess tail (24
            # real rows + 5 guesses) and a verify forward (the 5 guesses)
            _kernel_case(fro, Q=SPEC_PRIME_Q, seed=26, timed=True, **full),
            _kernel_case(fro, Q=SPEC_S, seed=27, timed=True, **full)],
        "flash_ring_decode_int8": [
            _kernel_case(fro, Q=None, seed=11, timed=True, old=ring, **full8),
            _kernel_case(fro, Q=None, seed=12, timed=False, **ragged8),
            _kernel_case(fro, Q=None, seed=17, timed=False, int8=True, **odd)],
        "flash_ring_prime_ap_int8": [
            _kernel_case(fro, Q=19, seed=13, timed=True, old=ring, **full8),
            _kernel_case(fro, Q=26, seed=14, timed=True, old=ring, **full8),
            _kernel_case(fro, Q=5, seed=15, timed=False, **ragged8),
            _kernel_case(fro, Q=17, seed=16, timed=False, int8=True, **odd),
            _kernel_case(fro, Q=24, seed=24, timed=True, **full8),
            _kernel_case(fro, Q=32, seed=25, timed=True, **full8),
            _kernel_case(fro, Q=SPEC_PRIME_Q, seed=28, timed=True, **full8),
            _kernel_case(fro, Q=SPEC_S, seed=29, timed=True, **full8)],
    }
    torch.cuda.empty_cache()
    old = OldQmm(old_qmm) if old_qmm else None
    qmm = [_qmm_case(qm, R=R, K=K, N=N, seed=20 + i, timed=True, old=old)
           for i, (R, (K, N)) in enumerate(
               (R, kn) for R in QMM_ROWS for kn in TRUNK.values())]
    qmm += [_qmm_case(qm, R=R, K=K, N=N, seed=80 + i, timed=False)
            for i, (R, K, N) in enumerate(QMM_EDGE)]
    if not any(c["plan"]["split"] > 1
               and c["plan"]["split"] * c["plan"]["kps"] > c["plan"]["nk"]
               for c in qmm):
        raise AssertionError("no K9 case ran a split with a shorter last "
                             "split")
    cases["quant_matmul"] = qmm
    host_us = _qmm_host_us(qm, old)
    torch.cuda.empty_cache()
    old_fwd = OldRelFwd(old_rel_fwd, not probe) if old_rel_fwd else None
    cases["flash_rel_attention"] = [
        # (a) the validation forward: seq 1024, no memory (causal: the
        # same_length window is empty at klen = mem_len)
        _rel_case(fra, B=4, qlen=1024, klen=1024, mem_len=1024,
                  same_length=True, seed=50, timed=True, old=old_fwd),
        # (b) the trunk over 1024 memory rows (decode_rl): window active
        _rel_case(fra, B=4, qlen=256, klen=1280, mem_len=1024,
                  same_length=True, seed=51, timed=True, old=old_fwd),
        # (c) ragged, as the JAX anylen wrapper admits it
        _rel_case(fra, B=1, qlen=100, klen=1124, mem_len=1024,
                  same_length=True, seed=52, timed=False),
        # (d) the realigned one-shot prime (decode_rl_kv): the image
        # phase's 1052-token expert prompt whole over 1024 cache rows, with
        # the window and without it
        _rel_case(fra, B=2, qlen=1052, klen=2076, mem_len=1024,
                  same_length=True, seed=53, timed=False),
        _rel_case(fra, B=2, qlen=1052, klen=2076, mem_len=1024,
                  same_length=False, seed=54, timed=False),
        # (e) the caption prime of pretrain_vision's eval tick: [9 prompt
        # tokens | 196 patches | one EOS] over 1024 cache rows, B 8
        _rel_case(fra, B=GEN_B, qlen=IC_PRIME_Q, klen=1024 + IC_PRIME_Q,
                  mem_len=1024, same_length=True, seed=55, timed=True),
        # (f) the generate phase's 64-token text prompt over 1024 rows
        _rel_case(fra, B=GEN_B, qlen=GEN_PROMPT, klen=1024 + GEN_PROMPT,
                  mem_len=1024, same_length=True, seed=56, timed=True),
        # (g) the stateless window decode: a 1024-token window, no memory,
        # one row (the episode) and STATELESS_B rows (decode_batch)
        _rel_case(fra, B=1, qlen=1024, klen=1024, mem_len=1024,
                  same_length=True, seed=57, timed=True),
        _rel_case(fra, B=STATELESS_B, qlen=1024, klen=1024, mem_len=1024,
                  same_length=True, seed=58, timed=True)]
    torch.cuda.empty_cache()
    cases["flash_rel_attention_bwd"] = [
        # (a) the train step's shape: B 4, seq 1024, causal
        _rel_bwd_case(fra, B=4, qlen=1024, klen=1024, mem_len=1024,
                      same_length=True, seed=60, timed=True, old=old_bwd),
        # (b) over 1024 memory rows, window active
        _rel_bwd_case(fra, B=4, qlen=256, klen=1280, mem_len=1024,
                      same_length=True, seed=61, timed=True, old=old_bwd),
        # (c) ragged
        _rel_bwd_case(fra, B=1, qlen=100, klen=1124, mem_len=1024,
                      same_length=True, seed=62, timed=False)]
    rec = {"phase": "kernels", "cases": cases, "qmm_host_us": host_us,
           "w8a8_int32": _w8a8_check(qm)}
    if old_bwd:
        rec["old_rel_bwd_resources"] = old_bwd.resources
    if ring:
        rec["old_ring_resources"] = ring.resources
    if old_fwd:
        rec["old_rel_fwd_resources"] = old_fwd.resources
    return rec


K_REPLACES = {
    "flash_ring_decode": "bdm_db1_tpu/ops/flash_ring_decode.py:249",
    "flash_ring_prime_ap": "bdm_db1_tpu/ops/flash_ring_decode.py:578",
    "flash_ring_decode_int8": "bdm_db1_tpu/ops/flash_ring_decode.py:166",
    "flash_ring_prime_ap_int8": "bdm_db1_tpu/ops/flash_ring_decode.py:497",
    "flash_ring_prime": "bdm_db1_tpu/ops/flash_ring_decode.py:671",
    "quant_matmul": "bdm_db1_tpu/ops/quant_matmul.py:125",
    "flash_rel_attention": "bdm_db1_tpu/ops/pallas_attention.py:50",
    "flash_rel_attention_bwd_dq": "bdm_db1_tpu/ops/pallas_attention.py:244",
    "flash_rel_attention_bwd_dkv": "bdm_db1_tpu/ops/pallas_attention.py:299",
}
K_SOURCES = {name: "bdm_db1_tpu_torch/csrc/flash_ring_decode.cu"
             for name in K_REPLACES}
K_SOURCES["quant_matmul"] = "bdm_db1_tpu_torch/csrc/quant_matmul.cu"
K_SOURCES["flash_rel_attention"] = \
    "bdm_db1_tpu_torch/csrc/flash_rel_attention.cu"
for _name in ("flash_rel_attention_bwd_dq", "flash_rel_attention_bwd_dkv"):
    K_SOURCES[_name] = "bdm_db1_tpu_torch/csrc/flash_rel_attention_bwd.cu"
# Kernel route (use_kernels True) against the plain ring branch (False) on
# the card. Per layer, on identical inputs, the attention output before
# o_net: max |diff| / max |attn|. The routes differ only by bf16 roundings
# (the query cast, p cast per key split against the full softmax), a few
# 2^-9 of a value; 2e-2 leaves room for that and none for a wrong mask,
# scale, rotation or merge, which move attention outputs by O(1) of their
# size. The int8 cache holds the same int8 values and scales on both
# routes, so the same limit holds there. The same limit holds K3 against
# rel_attention in the validation forward: p cast per key tile against the
# full softmax, and both outputs rounded to bf16. The gates stay within one
# layer: end to end, 24 layers grow any rounding difference (see the
# bf16-against-f32 readings beside them).
ATTN_REL_TOL = 2e-2
# The last layer run both ways from one input, then the tied head: max
# |diff| / max |logit|. One layer's rounding difference passes o_net, two
# LayerNorms, the FF and the head once (not 24 layers); a wrong route in
# that layer moves the logits by O(1) of their size.
LOGIT_REL_TOL = 5e-2


class _Recorder:
    """Keeps every action-token block a decoder returns (device tensors,
    read after the run) and, on the speculative path, the verify rounds of
    each call; passes everything else through."""

    def __init__(self, inner):
        self.inner = inner
        self.acts = []
        self.rounds = []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def decode_async(self, *args, **kwargs):
        act, mems = self.inner.decode_async(*args, **kwargs)
        self.acts.append(act)
        if self.inner.last_spec_rounds is not None:
            self.rounds.append(self.inner.last_spec_rounds)
        return act, mems


class _RecordingPool:
    def __init__(self, pool):
        self.pool = pool
        self.decoders = {}

    def get(self, tenv):
        dec = self.pool.get(tenv)
        return self.decoders.setdefault(id(dec), _Recorder(dec))


def _serve_setup(n_envs, episode_len, seed, **model_overrides):
    from bdm_db1_tpu_torch.core.config import db1_1p2b
    from bdm_db1_tpu_torch.data.rl_dataset import (
        RLFullDataset, RLTokenizerSuite, TrajectoryStore,
    )
    from bdm_db1_tpu_torch.eval.envs import FakeContinuousEnv
    from bdm_db1_tpu_torch.eval.wrapper import TokenizedEnv
    from bdm_db1_tpu_torch.models.transformer_xl import TransformerXL
    from bdm_db1_tpu_torch.tokenizers.scalar import ScalarTokenizer

    cfg = db1_1p2b(**model_overrides)
    cfg.model.param_dtype = "bfloat16"   # served weights in bf16
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = TransformerXL(cfg.model, cfg.vocab, device="cuda", generator=gen)
    layout = cfg.vocab.layout()
    suite = RLTokenizerSuite(layout,
                             ScalarTokenizer(cfg.vocab.num_continuous_bin))

    def env_fn(s):
        return FakeContinuousEnv(obs_dim=17, act_dim=6,
                                 episode_len=episode_len, seed=s)

    store = TrajectoryStore.from_flat_dataset(env_fn(999).make_dataset(3))
    ds = RLFullDataset("halfcheetah-geometry", store, suite,
                       seq_length=cfg.model.n_position, seed=0)

    def make_tenv(name):
        return TokenizedEnv(env_fn(int(name.split("-")[-1])), ds)

    names = [f"halfcheetah-{i}" for i in range(n_envs)]
    return cfg, model, layout, names, make_tenv


def _counters():
    from bdm_db1_tpu_torch.ops import flash_rel_attention as fra
    from bdm_db1_tpu_torch.ops import flash_ring_decode as fro
    from bdm_db1_tpu_torch.ops import quant_matmul as qm

    return fro.LAUNCHES, qm.LAUNCHES, fra.LAUNCHES


def _reset_launches():
    from bdm_db1_tpu_torch.ops import quant_matmul as qm

    for counts in _counters():
        for name in counts:
            counts[name] = 0
    qm.ROW_LAUNCHES.clear()


def _read_launches() -> dict:
    return {k: v for counts in _counters() for k, v in counts.items()}


def phase_serve(smi: str, *, phase: str, batch: int, steps: int = 8,
                seed: int = 0, **model_overrides) -> dict:
    from bdm_db1_tpu_torch.eval.decode import DecoderPool
    from bdm_db1_tpu_torch.eval.harness import evaluate_envs_lockstep
    from bdm_db1_tpu_torch.ops import flash_ring_decode as fro
    from bdm_db1_tpu_torch.ops import quant_matmul as qm

    cfg, model, layout, names, make_tenv = _serve_setup(
        batch, steps, seed, **model_overrides)
    int8_cache = cfg.model.decode_cache_dtype == "int8"
    int8_weights = cfg.model.decode_weight_dtype == "int8"
    L, A = cfg.model.n_layer, 6
    run = dict(num_trials=1, seed=100, batch_size=batch, interleave=1,
               strict_length=True)
    pool = _RecordingPool(DecoderPool(model, pad_buckets="default"))
    # warm-up: allocator, cuBLAS handles, the positional projections (and,
    # with int8 weights, the one-off weight quantization)
    evaluate_envs_lockstep(model, names, make_tenv, decoder_pool=pool,
                           max_step_size=2, **run)
    torch.cuda.synchronize()
    for rec in pool.decoders.values():
        rec.acts.clear()
    if int8_weights and not model.decode_weights_quantized():
        raise AssertionError("int8 decode weights were not quantized")

    # ---- the main path, counted --------------------------------------
    _reset_launches()
    t0 = time.perf_counter()
    res = evaluate_envs_lockstep(model, names, make_tenv, decoder_pool=pool,
                                 max_step_size=steps, **run)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_launches()
    qmm_rows = dict(sorted(qm.ROW_LAUNCHES.items()))
    # ------------------------------------------------------------------

    # the chunk plan: step 0 primes [prompt || obs || sep] in ring slices
    # (at 1.2B: 256-token slices on the plain ring branch, the last, 26
    # tokens padded to its bucket, 32, on the prime kernel); every later
    # step primes [deferred action || obs || sep], 19 tokens padded to 24;
    # each step then runs A - 1 single-token forwards. Every forward runs L
    # layers, each with 4 trunk matrices.
    dec = pool.get(make_tenv(names[0])).inner
    prompt, _ = make_tenv(names[0]).get_prompt(
        strict_length=True, rng=np.random.RandomState(0))
    q0 = len(prompt) + dec.obs_length + 1
    slices, widths = _prime_widths(dec, q0)
    forwards = len(slices) + steps * (A - 1) + (steps - 1)
    suffix = "_int8" if int8_cache else ""
    want = dict.fromkeys(launches, 0)
    want["flash_ring_decode" + suffix] = L * (
        steps * (A - 1) + slices.count(1))
    want["flash_ring_prime_ap" + suffix] = L * (
        steps - 1 + sum(2 <= q <= fro.MAX_PRIME_Q for q in slices))
    if int8_weights:
        want["quant_matmul"] = 4 * L * forwards
    if launches != want:
        raise AssertionError(f"kernel launches {launches}, expected {want}")
    # K9 by row count: each forward's rows are its tokens x the batch (the
    # prompt slices, the 19-token steady primes, the single-token forwards)
    rows_want = {}
    if int8_weights:
        for rows, n in ([(q * batch, 1) for q in slices]
                        + [(widths["steady"] * batch, steps - 1),
                           (batch, steps * (A - 1))]):
            rows_want[rows] = rows_want.get(rows, 0) + 4 * L * n
        rows_want = dict(sorted(rows_want.items()))
    if (qmm_rows != rows_want
            or sum(qmm_rows.values()) != want["quant_matmul"]):
        raise AssertionError(f"K9 launches by rows {qmm_rows}, expected "
                             f"{rows_want} (sum {want['quant_matmul']})")
    if not all(r["length_mean"] == steps and r["num_trials"] == 1
               and np.isfinite(r["return_mean"]) for r in res):
        raise AssertionError(f"episode records off: {res[:3]}")
    acts = torch.cat([a for rec in pool.decoders.values()
                      for a in rec.acts]).cpu().numpy()
    if acts.shape != (steps * batch, A) or not (
            (acts >= layout.continuous_offset)
            & (acts < layout.separator_id)).all():
        raise AssertionError(f"action tokens off: shape {acts.shape}, "
                             f"range {acts.min()}..{acts.max()}")

    # buckets on and off on one host, in turns (on, off, off, on, off, on,
    # on, off; the unpadded pool warmed first): steady rates, idle shares
    # and the host's largest costs of both
    unpadded = _RecordingPool(DecoderPool(model))
    _steady_steps(model, unpadded, make_tenv, names, layout, A, n=1)
    pools = {"padded": pool, "unpadded": unpadded}
    turns = [(name, _steady_steps(model, pools[name], make_tenv, names,
                                  layout, A))
             for name in ("padded", "unpadded", "unpadded", "padded",
                          "unpadded", "padded", "padded", "unpadded")]
    steady = turns[0][1]
    buckets_ab = {name: {key: [t[key] for n, t in turns if n == name]
                         for key in ("steady_actions_per_sec",
                                     "steady_step_ms_median",
                                     "device_busy_ms", "device_idle_share",
                                     "host_top_ms")}
                  for name in pools}
    routes = _route_check(model, layout, batch, make_tenv, names,
                          f32_copy=not (int8_cache or int8_weights))
    buckets = _bucket_check(model, make_tenv, names, layout)
    return {"phase": phase, "config": "db1_1p2b", "dtype": "bfloat16",
            "decode_cache_dtype": cfg.model.decode_cache_dtype,
            "decode_weight_dtype": cfg.model.decode_weight_dtype,
            "batch": batch, "env_steps": steps, "card": smi,
            "prime_slices": slices, "prime_widths": widths,
            "forwards": forwards,
            "launches": launches, "launches_expected": want,
            "qmm_launches_by_rows": qmm_rows,
            "wall_s": wall, "actions_per_sec": batch * steps / wall,
            **steady, "buckets_ab": buckets_ab, "kernel_vs_plain": routes,
            "buckets": buckets}


def _prime_widths(dec, q0: int, n_frames=None) -> tuple:
    """A bucketed decoder's ring calls: (the first prime's widths, {the
    first prime's widths and real rows of its last call, the steady
    [deferred || obs || sep] prime's width and real rows}). Raises unless
    the steady prime is padded to one width the prime kernel takes."""
    from bdm_db1_tpu_torch.ops import flash_ring_decode as fro

    slices, _, first_real = dec.prime_plan(q0, 0, n_frames)
    steady, _, real = dec.prime_plan(dec.obs_length + 2, 1,
                                     None if n_frames is None else 1)
    if real is None or len(steady) != 1 or steady[0] > fro.MAX_PRIME_Q:
        raise AssertionError(f"the steady prime is not padded to one prime "
                             f"kernel width: {steady}, real {real}")
    return slices, {"first": slices, "first_real_last": first_real,
                    "steady": steady[0], "steady_real": real}


def _copy_cache(c: dict) -> dict:
    return {k: v.clone() if torch.is_tensor(v) else v for k, v in c.items()}


def _step_obs(tenvs, act, sep):
    """Step every env by its decoded continuous action: the next [obs ||
    sep] primes [B, obs + 1]."""
    obs, _ = tenvs[0].encode_obs_batch(
        [np.asarray(t.env.step(a)[0]) for t, a in zip(
            tenvs, tenvs[0].tok.decode_action_batch(act, False))])
    return np.concatenate([obs, sep], 1)


def _start_primes(tenvs, sep, seed):
    rng = np.random.RandomState(seed)
    return np.stack([np.concatenate([t.get_prompt(rng=rng)[0],
                                     t.reset()[0], sep[0]]) for t in tenvs])


# Geometry buckets on the card: the first-action logits of one steady
# prime padded to its bucket width against the same prime unpadded, from
# one cache: max |diff| / max |logit|. The real rows see the same keys
# through the same masks, so only rounding may differ (cuBLAS may take
# another algorithm at 24 rows than at 19); a logit read off a pad row
# moves them by O(1). A pad committed into the ring, or a wrong cursor,
# shows only in the next forward: the slots the pads point at must keep
# their values bit for bit, the cursor must advance by the real rows, and
# over BUCKET_STEPS env steps the bucketed decoder's actions must equal
# the unpadded decoder's in at least BUCKET_ACTION_SHARE of the tokens.
BUCKET_LOGIT_TOL = 1e-3
BUCKET_ACTION_SHARE = 0.9
BUCKET_B = 8
BUCKET_STEPS = 4


@torch.no_grad()
def _bucket_check(model, make_tenv, names, layout) -> dict:
    """BUCKET_B envs of the serve geometry: one episode-start prime
    through the unpadded decoder into one cache, copied; the first steady
    prime's logits and caches from both copies, padded to its bucket width
    (real_q) and unpadded (``decode_rl_kv_ring`` directly): the logits'
    gap, the pads' slots against the cache before, the cursors; then
    BUCKET_STEPS env steps through the bucketed and the unpadded decoder,
    one copy each, the envs stepped by the unpadded decoder's actions: the
    share of equal action tokens. Gated as BUCKET_* say."""
    from bdm_db1_tpu_torch.data.packing import action_flags_and_position_ids
    from bdm_db1_tpu_torch.eval.decode import build_decoder_for_env

    tenvs = [make_tenv(nm) for nm in names[:BUCKET_B]]
    plain = build_decoder_for_env(model, tenvs[0])
    padded = build_decoder_for_env(model, tenvs[0], pad_buckets="default")
    B = len(tenvs)
    sep = np.full((B, 1), layout.separator_id, np.int64)
    act, mems = plain.decode(_start_primes(tenvs, sep, 7),
                             plain.init_mems(B), defer_last=True)
    prime = np.concatenate([act[:, -1:], _step_obs(tenvs, act, sep)], 1)
    q = prime.shape[1]
    widths, _, real = padded.prime_plan(q, 1)
    w = widths[0]
    _, p = action_flags_and_position_ids(q - 1, plain.obs_length,
                                         plain.action_length, 0)
    pos = np.broadcast_to(np.concatenate([[0], p]), (B, q))
    tok_t = torch.as_tensor(prime, device="cuda")
    pos_t = torch.as_tensor(pos.copy(), device="cuda")
    pad = torch.zeros((B, w - q), dtype=torch.int64, device="cuda")
    lg_p, ring_p = model.decode_rl_kv_ring(
        torch.cat([tok_t, pad], 1), torch.cat([pos_t, pad], 1),
        _copy_cache(mems), model.precompute_rk(w), real_q=real)
    lg_u, ring_u = model.decode_rl_kv_ring(tok_t, pos_t, _copy_cache(mems),
                                           model.precompute_rk(q))
    err = float((lg_p - lg_u).abs().max() / lg_u.abs().max())
    M = model.cfg.mem_len
    c = int(mems["cursor"])
    pad_slots = torch.as_tensor([(c + t) % M for t in range(q, w)],
                                device="cuda")
    tensors = [k for k, v in mems.items() if torch.is_tensor(v)]
    pads_kept = all(torch.equal(ring_p[k].index_select(2, pad_slots),
                                mems[k].index_select(2, pad_slots))
                    for k in tensors)
    cursors = [int(ring_p["cursor"]), int(ring_u["cursor"])]
    cache_diff = max(float((ring_p[k].float() - ring_u[k].float()).abs()
                           .max()) for k in tensors)

    caches = {"padded": _copy_cache(mems), "plain": mems}
    deferred = {"padded": act[:, -1], "plain": act[:, -1]}
    equal = total = 0
    for _ in range(BUCKET_STEPS):
        obs = _step_obs(tenvs, act, sep) if total else prime[:, 1:]
        acts = {}
        for name, dec in (("padded", padded), ("plain", plain)):
            acts[name], caches[name] = dec.decode(
                obs, caches[name], deferred_tok=deferred[name],
                defer_last=True)
            deferred[name] = acts[name][:, -1]
        equal += int((acts["padded"] == acts["plain"]).sum())
        total += acts["plain"].size
        act = acts["plain"]
    rec = {"batch": B, "steady_prime": q, "bucket_width": w,
           "first_action_logits_rel_diff": err, "tol": BUCKET_LOGIT_TOL,
           "pad_slots_kept": pads_kept, "cursors": cursors,
           "cache_max_abs_diff": cache_diff, "env_steps": BUCKET_STEPS,
           "equal_action_share": equal / total,
           "share_min": BUCKET_ACTION_SHARE}
    if not (np.isfinite(err) and err <= BUCKET_LOGIT_TOL and pads_kept
            and cursors == [(c + q) % M] * 2
            and equal / total >= BUCKET_ACTION_SHARE):
        raise AssertionError(f"padded against unpadded prime: {rec}")
    return rec


def _steady_steps(model, pool, make_tenv, names, layout, A,
                  n: int = 10) -> dict:
    """Steady-state env steps driven directly (prime [deferred || obs ||
    sep], the deferred lead the decoder's ``defer_width`` tokens), each
    ended by a device sync. The rate is all n steps' actions over their
    summed wall time. The idle share is one profiled step's summed kernel
    time against the median unprofiled step (the profiler slows the host,
    so the profiled step's own wall time is not used). A speculative
    decoder's verify rounds of the n steps are kept."""
    tenvs = [make_tenv(nm) for nm in names]
    dec = pool.get(tenvs[0]).inner
    B = len(tenvs)
    sep = np.full((B, 1), layout.separator_id, np.int64)
    act, mems = dec.decode(_start_primes(tenvs, sep, 5), dec.init_mems(B),
                           defer_last=True)

    def step(act, mems):
        return dec.decode(_step_obs(tenvs, act, sep), mems,
                          deferred_tok=act[:, -dec.defer_width:],
                          defer_last=True)

    times, rounds = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        act, mems = step(act, mems)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if dec.speculates:
            rounds.append(dec.last_spec_rounds)
    busy, top, prof_wall, host = _profile_busy(lambda: step(act, mems))
    step_s = float(np.median(times))
    extra = {"verify_rounds": rounds} if rounds else {}
    return {**extra, "steady_actions_per_sec": n * B / sum(times),
            "steady_step_ms_median": step_s * 1e3,
            "steady_step_ms": [t * 1e3 for t in times],
            "profiled_step_ms": prof_wall * 1e3,
            "device_busy_ms": busy * 1e3,
            "device_idle_share": 1.0 - busy / step_s,
            "top_device_ms": top, "host_top_ms": host}


def _profile_busy(fn, keep=()):
    """One profiled call of fn ending in a device sync: (summed device time
    s, the largest kernels by name in ms and any whose name holds one of
    ``keep``, the call's wall time s, the 8 host events (operators and CUDA
    runtime calls) with the most self CPU time in ms and, under "all",
    their sum over all host events)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # kernels only: a user annotation (the optimizer's step range) spans
    # kernels on the device timeline and would count them twice
    events = prof.key_averages()
    kern = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    host = sorted((e for e in events
                   if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)
    host_ms = {e.key[:60]: e.self_cpu_time_total / 1e3 for e in host[:8]}
    host_ms["all"] = sum(e.self_cpu_time_total for e in host) / 1e3
    busy = sum(e.self_device_time_total for e in kern) / 1e6
    ranked = sorted(kern, key=lambda e: -e.self_device_time_total)
    top = ranked[:8] + [e for e in ranked[8:] if any(k in e.key for k in keep)]
    # names without the namespace noise, long enough that the template
    # instantiations of one kernel stay apart
    return busy, {e.key.replace("(anonymous namespace)::", "")[:100]:
                  e.self_device_time_total / 1e3 for e in top}, wall, host_ms


# kernels timed alone in the train profile, by the row of the kernels line
ALONE_KERNELS = {"flash_rel_attention": "k3_rel_attention_kernel",
                 "flash_rel_attention_bwd_dq": "k4_rel_bwd_dq_kernel",
                 "flash_rel_attention_bwd_dkv": "k5_rel_bwd_dkv_kernel"}


def kernel_alone_ms(device_ms: dict, launches: dict) -> dict:
    """ms per launch of each kernel of ALONE_KERNELS, the kernel alone: its
    device time in a profile (``_profile_busy``'s kernels by name, ms) over
    its launches in the profiled call. A kernel the profile does not list,
    or that was not launched, is left out."""
    out = {}
    for row, kernel in ALONE_KERNELS.items():
        hits = [ms for name, ms in device_ms.items() if kernel in name]
        if hits and launches.get(row):
            out[row] = sum(hits) / launches[row]
    return out


@torch.no_grad()
def _route_check(model, layout, B, make_tenv, names, f32_copy=True,
                 spec: int = 0) -> dict:
    """One observation prime and one single-token forward from the same
    primed cache, driven layer by layer. Each layer's attention output with
    use_kernels True (the kernels) is held against use_kernels False (the
    plain ring branch) on the same input, and so are the logits after the
    last layer run both ways from its one input. Beside those gates, with
    ``f32_copy`` (a bf16 cache and weights), an f32 copy of the model reads
    how far bf16 alone moves each layer's output from the same bf16 input
    ("local"), the running hidden state ("propagated") and the
    last-position logits. An image env's primes carry their frames: the
    prompt's and the reset observation's in the cache-filling prime, the
    new observation's in the prime under the check. With ``spec`` S (the
    speculative decode's shapes): the prime is [the whole action block ||
    obs || sep || S guesses] and the second forward a verify of S rows."""
    from bdm_db1_tpu_torch.eval.decode import build_decoder_for_env
    from bdm_db1_tpu_torch.models.transformer_xl import TransformerXL

    tenvs = [make_tenv(nm) for nm in names[:B]]
    dec = build_decoder_for_env(model, tenvs[0])
    rng = np.random.RandomState(9)
    sep = np.full((B, 1), layout.separator_id, np.int64)
    starts, frames = [], []
    for t in tenvs:
        prompt, prompt_img = t.get_prompt(rng=rng)
        obs, img, _ = t.reset()
        starts.append(np.concatenate([prompt, obs, sep[0]]))
        frames.append(None if img is None
                      else np.concatenate([prompt_img, img]))
    act, cache = dec.decode(
        np.stack(starts), dec.init_mems(B), defer_last=True,
        prime_images=None if frames[0] is None else np.stack(frames))
    resets = [t.reset() for t in tenvs]
    obs = np.stack([r[0] for r in resets])
    img = (None if resets[0][1] is None else
           torch.as_tensor(np.stack([r[1] for r in resets]), device="cuda"))
    lead = act if spec else act[:, -1:]
    guesses = act[:, :spec]
    prime = torch.as_tensor(np.concatenate([lead, obs, sep, guesses], axis=1),
                            device="cuda")
    pos = torch.as_tensor(np.broadcast_to(np.concatenate([
        np.zeros(lead.shape[1], np.int64), np.arange(1, obs.shape[1] + 2),
        np.zeros(spec, np.int64)]), prime.shape).copy(), device="cuda")
    if spec:
        second = ("verify", torch.as_tensor(guesses, device="cuda"))
    else:
        second = ("q1", torch.full((B, 1), layout.continuous_offset + 3,
                                   device="cuda"))
    zero = torch.zeros_like(second[1])

    m32 = cache32 = None
    if f32_copy:
        m32 = TransformerXL(dataclasses.replace(model.cfg, dtype="float32"),
                            model.vocab, device="cuda")
        m32.load_state_dict(model.state_dict())
        cache32 = {"k": cache["k"].float(), "v": cache["v"].float(),
                   "cursor": cache["cursor"]}

    def rel(a, b):
        return float((a.float() - b.float()).abs().max()
                     / b.float().abs().max())

    out = {"attn_tol": ATTN_REL_TOL, "logit_tol": LOGIT_REL_TOL,
           "prime_q": prime.shape[1], "images": img is not None}
    for name, tok, tpos, tim in (("prime", prime, pos, img),
                                 (*second, zero, None)):
        q = tok.shape[1]
        mask, mask_s = model.ring_masks(q, cache["cursor"], "cuda")
        rk = model.precompute_rk(q)
        h = model.embed_rl(tok, tpos, tim)
        if f32_copy:
            rk32, h32 = m32.precompute_rk(q), m32.embed_rl(tok, tpos, tim)
        attn_err, local, prop = [], [], []
        for li, layer in enumerate(model.h):
            ring = (rk[li], cache, li, mask, mask_s)
            attn = layer.dec_attn.attend_ring(h, *ring, True)[0]
            attn_p = layer.dec_attn.attend_ring(h, *ring, False)[0]
            attn_err.append(rel(attn, attn_p))
            h_in = h
            h = layer.forward_ring(h, *ring, True)[0]
            if f32_copy:
                layer32 = m32.h[li]
                ring32 = (rk32[li], cache32, li, mask, mask_s, False)
                local.append(rel(h, layer32.forward_ring(h_in.float(),
                                                         *ring32)[0]))
                h32 = layer32.forward_ring(h32, *ring32)[0]
                prop.append(rel(h, h32))
        logits = model.logits(h[:, -1])
        # the last layer both ways from the same input, through the head
        h_p = layer.forward_ring(h_in, *ring, False)[0]
        logits_p = model.logits(h_p[:, -1])
        out[name] = {"attn_rel_err_max": max(attn_err),
                     "last_layer_logits_rel_err": rel(logits, logits_p)}
        if f32_copy:
            out[name].update({
                "bf16_vs_f32_local_max": max(local),
                "bf16_vs_f32_propagated": prop,
                "logits_bf16_vs_f32": rel(logits, m32.logits(h32[:, -1]))})
        if not (torch.isfinite(logits).all()
                and out[name]["attn_rel_err_max"] <= ATTN_REL_TOL
                and out[name]["last_layer_logits_rel_err"] <= LOGIT_REL_TOL):
            raise AssertionError(f"kernel route vs plain ring branch: {out}")
    return out


# The validation loss of one micro-batch through the K3 route against the
# rel_attention route (attention_impl "xla"), same bf16 weights and data:
# |difference| at most EVAL_LOSS_TOL. Both routes round at other places
# (p per key tile, the bf16 PV product) and 24 layers carry that on. The
# readings that set it, on an H100: 1.8e-3 between the routes at a loss of
# 10.81, while the per-layer attention gap was at most 5.1e-3 of its
# largest value. With random weights the loss is near log V whatever the
# attention does, so this is a coarse end-to-end check; the per-layer
# ATTN_REL_TOL gate holds the route.
EVAL_LOSS_TOL = 1e-2
EVAL_MICRO = 4          # the JAX TrainConfig.micro_batch_size
EVAL_BATCHES = 8


def _eval_setup(seed: int, cfg=None, n_batches: int = EVAL_BATCHES + 1):
    """db1_1p2b in bf16 (or ``cfg``; random weights from ``seed``) and its
    validation micro-batches: packed samples (prompts on) of a seeded
    HalfCheetah-geometry fake dataset (17 obs + separator + 6 action tokens
    a step, 43 transitions per 1025-token sample), the valid split of the
    default "90,5,5", in sampler order. Each loader batch is [accum 1,
    micro 4]; the first of the ``n_batches`` warms up."""
    from bdm_db1_tpu_torch.core.config import db1_1p2b
    from bdm_db1_tpu_torch.data.rl_dataset import (
        RLFullDataset, RLTokenizerSuite, TrajectoryStore, split_rl_dataset,
    )
    from bdm_db1_tpu_torch.data.samplers import (
        SequentialSampler, collate_modalities,
    )
    from bdm_db1_tpu_torch.eval.envs import FakeContinuousEnv
    from bdm_db1_tpu_torch.models.transformer_xl import TransformerXL
    from bdm_db1_tpu_torch.tokenizers.scalar import ScalarTokenizer

    if cfg is None:
        cfg = db1_1p2b()
        cfg.model.param_dtype = "bfloat16"
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = TransformerXL(cfg.model, cfg.vocab, device="cuda", generator=gen)
    store = TrajectoryStore.from_flat_dataset(FakeContinuousEnv(
        obs_dim=17, act_dim=6, episode_len=200, seed=999).make_dataset(20))
    suite = RLTokenizerSuite(cfg.vocab.layout(),
                             ScalarTokenizer(cfg.vocab.num_continuous_bin))
    full = RLFullDataset("halfcheetah-geometry", store, suite,
                         seq_length=cfg.data.seq_length, seed=seed)
    _, valid, _ = split_rl_dataset(full, cfg.data.split)
    sampler = iter(SequentialSampler(len(valid), 0, EVAL_MICRO, 0, 1))
    batches = []
    for _ in range(n_batches):
        raw = collate_modalities([valid[i] for i in next(sampler)], ["rl"])
        batches.append({m: {k: v[None] for k, v in f.items()}
                        for m, f in raw.items()})
    return cfg, model, full, batches


def phase_eval_loss(smi: str, seed: int = 0) -> dict:
    from bdm_db1_tpu_torch.train.trainer import evaluate_loss

    cfg, model, full, batches = _eval_setup(seed)
    L = cfg.model.n_layer
    seq = cfg.data.seq_length
    warm, batches = batches[0], batches[1:]
    evaluate_loss(model, [warm], device="cuda")
    torch.cuda.synchronize()

    # ---- the main path, counted --------------------------------------
    _reset_launches()
    losses, times = [], []
    for raw in batches:
        t0 = time.perf_counter()
        losses.append(evaluate_loss(model, [raw], device="cuda"))  # host read
        times.append(time.perf_counter() - t0)
    launches = _read_launches()
    # ------------------------------------------------------------------

    forwards = EVAL_BATCHES           # accum 1 per loader batch
    want = dict.fromkeys(launches, 0)
    want["flash_rel_attention"] = L * forwards
    if launches != want:
        raise AssertionError(f"kernel launches {launches}, expected {want}")
    loss = float(np.mean(losses))
    log_v = float(np.log(full.tok.layout.total_vocab_size))
    # random tied weights give logits of O(1): near-uniform, ~log V
    if not (np.isfinite(losses).all() and 0.5 * log_v < loss < 2 * log_v):
        raise AssertionError(f"validation losses off: {losses}")
    tokens = EVAL_MICRO * seq
    step = float(np.median(times))
    busy, top, _, _ = _profile_busy(
        lambda: evaluate_loss(model, [batches[0]], device="cuda"))
    routes = _eval_route_check(model, batches[0])
    del model
    gc.collect()
    torch.cuda.empty_cache()
    gate = _tiny_gate_check(seed)
    return {"phase": "eval_loss", "config": "db1_1p2b", "dtype": "bfloat16",
            "micro_batch": EVAL_MICRO, "seq_length": seq,
            "micro_batches": EVAL_BATCHES, "forwards": forwards,
            "valid_samples": len(batches) * EVAL_MICRO, "card": smi,
            "launches": launches, "launches_expected": want,
            "loss": loss, "losses": losses, "log_vocab": log_v,
            "tokens_per_sec": tokens * EVAL_BATCHES / sum(times),
            "micro_batch_ms_median": step * 1e3,
            "micro_batch_ms": [t * 1e3 for t in times],
            "device_busy_ms": busy * 1e3,
            "device_idle_share": 1.0 - busy / step,
            "top_device_ms": top, "kernel_vs_plain": routes,
            "tiny_gate": gate}


def _tiny_gate_check(seed: int) -> dict:
    """The trunk's kernel gate on the card: db1_tiny (head dim 16, outside
    K3's contract) at seq 1024, where the JAX gate's shapes qualify, under
    "auto" must take ``rel_attention``: ``evaluate_loss`` of one
    micro-batch gives a finite loss and launches no K3."""
    from bdm_db1_tpu_torch.core.config import db1_tiny
    from bdm_db1_tpu_torch.models.transformer_xl import use_rel_kernel
    from bdm_db1_tpu_torch.ops import flash_rel_attention as fra
    from bdm_db1_tpu_torch.train.trainer import evaluate_loss

    cfg = db1_tiny(n_position=1024)
    cfg.data.seq_length = 1024
    cfg, model, _, batches = _eval_setup(seed, cfg, n_batches=1)
    seq = cfg.data.seq_length
    k3 = fra.LAUNCHES["flash_rel_attention"]
    loss = evaluate_loss(model, batches, device="cuda")
    k3 = fra.LAUNCHES["flash_rel_attention"] - k3
    out = {"config": "db1_tiny", "d_head": cfg.model.d_head,
           "dtype": cfg.model.dtype,
           "attention_impl": cfg.model.attention_impl, "seq_length": seq,
           "shape_qualifies": fra.kernel_route_applicable(seq, seq),
           "kernel_route": use_rel_kernel(cfg.model, seq, seq, "cuda"),
           "loss": loss, "k3_launches": k3}
    if not (out["shape_qualifies"] and not out["kernel_route"]
            and np.isfinite(loss) and k3 == 0):
        raise AssertionError(f"the trunk's gate on db1_tiny: {out}")
    return out


@torch.no_grad()
def _eval_route_check(model, raw) -> dict:
    """One micro-batch driven layer by layer: each layer's attention output
    through K3 against ``rel_attention`` on the same input (limit
    ATTN_REL_TOL of its largest value); then the loss through each route
    end to end (limit EVAL_LOSS_TOL)."""
    from bdm_db1_tpu_torch.models.transformer_xl import use_rel_kernel
    from bdm_db1_tpu_torch.ops.attention import same_length_mask
    from bdm_db1_tpu_torch.ops.positional import relative_positional_embedding
    from bdm_db1_tpu_torch.train.trainer import evaluate_loss, to_gato_batch

    cfg = model.cfg
    rl = to_gato_batch({m: {k: v[0] for k, v in f.items()}
                        for m, f in raw.items()}, device="cuda")["rl"]
    qlen = rl.tokens.shape[1]
    if not use_rel_kernel(cfg, qlen, qlen, "cuda"):
        raise AssertionError("the validation forward does not take K3")
    mask = same_length_mask(qlen, qlen, cfg.mem_len, device="cuda")
    r = relative_positional_embedding(qlen, cfg.n_embed,
                                      cfg.effective_clamp_len, device="cuda")
    h = model.embed_rl(rl.tokens, rl.position_id)
    errs = []
    for layer in model.h:
        attn = layer.dec_attn.attend(h, r, None, mask, True)
        attn_p = layer.dec_attn.attend(h, r, None, mask, False)
        errs.append(float((attn.float() - attn_p.float()).abs().max()
                          / attn_p.float().abs().max()))
        h = layer(h, None, r, mask, True)
    loss_k = evaluate_loss(model, [raw], device="cuda")
    impl = cfg.attention_impl
    cfg.attention_impl = "xla"       # the rel_attention route
    try:
        loss_p = evaluate_loss(model, [raw], device="cuda")
    finally:
        cfg.attention_impl = impl
    out = {"attn_tol": ATTN_REL_TOL, "attn_rel_err": errs,
           "attn_rel_err_max": max(errs), "loss_kernel": loss_k,
           "loss_plain": loss_p, "loss_abs_diff": abs(loss_k - loss_p),
           "loss_tol": EVAL_LOSS_TOL}
    if not (max(errs) <= ATTN_REL_TOL and np.isfinite(loss_p)
            and abs(loss_k - loss_p) <= EVAL_LOSS_TOL):
        raise AssertionError(f"K3 route vs rel_attention: {out}")
    return out


# The training gradients through the K3-K5 route against autograd through
# rel_attention. Per layer, on the same bf16 inputs (rel_attention in f32
# over them) and the same seeded upstream gradient, each of the six
# gradients: max |diff| at most GRAD_REL_TOL of its largest value. K4/K5
# round p and dS to bf16 for the tensor-core products and dq, dk, dv to
# bf16 on output, so each gradient carries a few 2^-9 of its size; a wrong
# mask, shift or scale moves a gradient by O(1) of its size. Readings on an
# H100 80GB HBM3 (700 W), worst layer of 24, two runs (the loader's threads
# may hand the check another micro-batch): dq 1.6e-2 / 1.4e-2, dk 6.7e-3 /
# 5.8e-3, dv 3.7e-3 / 3.7e-3, drk 9.7e-3 / 7.4e-3, drw 1.8e-2 / 2.2e-2, drr
# 2.3e-2 / 2.1e-2.
GRAD_REL_TOL = 5e-2
# The whole model's gradient on one micro-batch through both routes with
# the same dropout masks: the global norms within GRAD_NORM_RTOL of each
# other and a cosine similarity of at least GRAD_COS_MIN. Both routes round
# at other places (bf16 p, dS and outputs in the kernels) and 24 layers
# carry that on, so this is a coarse end-to-end check; the per-layer
# GRAD_REL_TOL gate holds the route. Readings on an H100 80GB HBM3 (700 W),
# two runs: norms 7.1e-3 and 8.8e-3 apart, cosines 0.9921 and 0.9908.
GRAD_NORM_RTOL = 3e-2
GRAD_COS_MIN = 0.98
TRAIN_MICRO = 4         # the JAX TrainConfig.micro_batch_size
TRAIN_ACCUM = 2
TRAIN_STEPS = 8


def _train_setup(seed: int, **model_overrides):
    """db1_1p2b with bf16 activations and f32 parameters (random weights
    from ``seed``), the ModelConfig dropout rates (flax dropout) unless
    ``model_overrides`` changes them, and the OptimizerConfig defaults; its
    train split of the eval phase's dataset wired as
    ``pretrain.build_loader`` wires it: RandomSampler(seed =
    TrainConfig.seed), mixture counts {"rl": 4} and StratifiedGatoLoader
    with accum 2."""
    from bdm_db1_tpu_torch.core.config import db1_1p2b
    from bdm_db1_tpu_torch.data.rl_dataset import (
        RLFullDataset, RLTokenizerSuite, TrajectoryStore, split_rl_dataset,
    )
    from bdm_db1_tpu_torch.data.samplers import (
        RandomSampler, StratifiedGatoLoader, mixture_counts,
    )
    from bdm_db1_tpu_torch.eval.envs import FakeContinuousEnv
    from bdm_db1_tpu_torch.models.transformer_xl import TransformerXL
    from bdm_db1_tpu_torch.tokenizers.scalar import ScalarTokenizer

    cfg = db1_1p2b(**model_overrides)
    assert (cfg.model.dtype, cfg.model.param_dtype) == ("bfloat16",
                                                        "float32")
    cfg.train = dataclasses.replace(
        cfg.train, micro_batch_size=TRAIN_MICRO,
        global_batch_size=TRAIN_MICRO * TRAIN_ACCUM, log_interval=1,
        eval_interval=1 << 30)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = TransformerXL(cfg.model, cfg.vocab, device="cuda", generator=gen)
    store = TrajectoryStore.from_flat_dataset(FakeContinuousEnv(
        obs_dim=17, act_dim=6, episode_len=200, seed=999).make_dataset(20))
    suite = RLTokenizerSuite(cfg.vocab.layout(),
                             ScalarTokenizer(cfg.vocab.num_continuous_bin))
    full = RLFullDataset("halfcheetah-geometry", store, suite,
                         seq_length=cfg.data.seq_length, seed=seed)
    train = split_rl_dataset(full, cfg.data.split)[0]
    counts = mixture_counts({"rl": 1.0}, cfg.train.micro_batch_size)
    accum = cfg.train.global_batch_size // cfg.train.micro_batch_size
    sampler = RandomSampler(len(train), 0, counts["rl"], 0, 1,
                            seed=cfg.train.seed)
    loader = StratifiedGatoLoader({"rl": train}, {"rl": sampler}, counts,
                                  accum, num_threads=cfg.data.num_workers)
    return cfg, model, full, loader


def phase_train(smi: str, ckpt_dir: str, saved_weights: dict,
                seed: int = 0) -> dict:
    from bdm_db1_tpu_torch.train.step import init_train_state, make_train_step
    from bdm_db1_tpu_torch.train.trainer import Trainer, to_gato_batch

    cfg, model, full, loader = _train_setup(seed)
    L = cfg.model.n_layer
    try:
        raw = next(loader)
        routes = _train_route_check(model, to_gato_batch(
            {m: {k: v[0] for k, v in f.items()} for m, f in raw.items()},
            "cuda"))
        torch.cuda.empty_cache()
        state = init_train_state(model, cfg.train.optimizer,
                                 cfg.train.train_iters)
        step = make_train_step(model)
        marks, losses = [], []

        def timed_step(st, batch, gen):
            marks.append(time.perf_counter())
            st, met = step(st, batch, gen)
            losses.append(met["loss"])
            return st, met

        def run(n, st):
            tcfg = dataclasses.replace(cfg, train=dataclasses.replace(
                cfg.train, train_iters=n))
            trainer = Trainer(tcfg, model, timed_step, st, loader)
            trainer.train()
            return trainer.state

        state = run(1, state)                   # warm-up
        torch.cuda.synchronize()
        before = [p.detach().clone() for p in model.parameters()]
        marks.clear()
        losses.clear()
        torch.cuda.reset_peak_memory_stats()

        # ---- the main path, counted ----------------------------------
        _reset_launches()
        state = run(TRAIN_STEPS, state)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        launches = _read_launches()
        # --------------------------------------------------------------

        peak = torch.cuda.max_memory_allocated()
        micro = TRAIN_STEPS * TRAIN_ACCUM
        want = dict.fromkeys(launches, 0)
        for name in ("flash_rel_attention", "flash_rel_attention_bwd_dq",
                     "flash_rel_attention_bwd_dkv"):
            want[name] = L * micro
        if launches != want:
            raise AssertionError(f"kernel launches {launches}, expected "
                                 f"{want}")
        losses = [float(x) for x in losses]
        log_v = float(np.log(full.tok.layout.total_vocab_size))
        if not (np.isfinite(losses).all()
                and 0.5 * log_v < losses[0] < 2 * log_v
                and losses[-1] < losses[0]):
            raise AssertionError(f"training losses off: {losses}")
        # an RL batch reaches every parameter but the vision tower's, which
        # keep no gradient and are skipped by the optimizer
        changed = {n: not torch.equal(a, p) for a, (n, p) in
                   zip(before, model.named_parameters())}
        finite = all(bool(torch.isfinite(p).all())
                     for p in model.parameters())
        del before
        vision = {n for n in changed if n.startswith("vision_encoder.")}
        if not (finite and vision and all(
                changed[n] != (n in vision) for n in changed)):
            raise AssertionError(
                f"parameters finite: {finite}, changed: "
                f"{sum(changed.values())} of {len(changed)}, vision tower "
                f"changed: {sum(changed[n] for n in vision)}")
        times = np.diff(marks)
        tokens = TRAIN_ACCUM * TRAIN_MICRO * cfg.data.seq_length
        step_s = float(np.median(times))
        batch = to_gato_batch(next(loader), "cuda")
        gen = torch.Generator(device="cuda").manual_seed(1)
        _reset_launches()
        busy, top, _, _ = _profile_busy(lambda: step(state, batch, gen),
                                     keep=tuple(ALONE_KERNELS.values()))
        alone = kernel_alone_ms(top, _read_launches())
        resume = _resume_check(state, step, batch, ckpt_dir, saved_weights,
                               smi)
    finally:
        loader.stop()
    return {"phase": "train", "config": "db1_1p2b", "dtype": "bfloat16",
            "param_dtype": "float32", "micro_batch": TRAIN_MICRO,
            "accum": TRAIN_ACCUM, "seq_length": cfg.data.seq_length,
            "steps": TRAIN_STEPS, "card": smi, "optimizer": dataclasses.asdict(
                cfg.train.optimizer),
            "dropout": {"drop": cfg.model.drop,
                        "embd_pdrop": cfg.model.embd_pdrop,
                        "dropattn": cfg.model.dropattn,
                        "impl": cfg.model.dropout_impl},
            "launches": launches, "launches_expected": want,
            "losses": losses, "log_vocab": log_v,
            "tokens_per_sec": tokens * TRAIN_STEPS / float(times.sum()),
            "step_ms_median": step_s * 1e3,
            "step_ms": [t * 1e3 for t in times],
            "device_busy_ms": busy * 1e3,
            "device_idle_share": 1.0 - busy / step_s,
            "max_memory_allocated_gb": peak / 1e9,
            "top_device_ms": top, "kernel_alone_ms": alone,
            "gradient_routes": routes, "resume": resume}


def _leaf_sums(state) -> dict:
    """Per leaf of the parameters and moments: the float64 sum of its
    values and the int64 sum of its raw bits (a changed bit moves it)."""
    opt = state.optimizer.state_dict()
    leaves = dict(state.model.named_parameters())
    for key in ("mu", "nu"):
        leaves.update({f"{key}.{n}": t for n, t in opt[key].items()})
    bits = {4: torch.int32, 2: torch.int16}
    return {n: (float(t.detach().double().sum()),
                int(t.detach().view(bits[t.element_size()]).sum(
                    dtype=torch.int64)))
            for n, t in leaves.items()}


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)


def _resume_check(state, step, batch, ckpt_dir: str, saved_weights: dict,
                  smi: str) -> dict:
    """Save the train state through CheckpointManager, take one step on
    ``batch`` with the live generator (loss L_a), restore into the same
    objects and take the step again with the restored generator (L_b).
    The restored parameters and moments must carry the saved sums and
    bits, and L_b must equal L_a bitwise: the loss comes out of the
    forward, which has no atomics (K5's f32 atomics touch only the
    gradients after it), under the same dropout masks. The checkpoint
    stays in ``ckpt_dir`` for evaluate_rl, and a host copy of the saved
    weights in ``saved_weights``."""
    from bdm_db1_tpu_torch.train.checkpoint import CheckpointManager

    mgr = CheckpointManager(ckpt_dir)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.save(state.step, state, client_state={"iteration": state.step})
    save_s = time.perf_counter() - t0
    saved = _leaf_sums(state)
    saved_weights.update({n: p.to("cpu", copy=True)
                          for n, p in state.model.state_dict().items()})
    nbytes = _dir_bytes(mgr.step_dir(state.step))
    gen_state = state.generator.get_state()
    _, met = step(state, batch, state.generator)
    loss_a = float(met["loss"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored, client = mgr.restore(state)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if restored is not state or client != {"iteration": state.step}:
        raise AssertionError(f"restore returned {client}")
    sums = _leaf_sums(state)
    bad = [n for n in saved if sums[n] != saved[n]]
    if bad or not torch.equal(state.generator.get_state(), gen_state):
        raise AssertionError(f"restored leaves differ from the saved ones: "
                             f"{bad[:5]} ({len(bad)} of {len(saved)})")
    _, met = step(state, batch, state.generator)
    loss_b = float(met["loss"])
    if loss_b != loss_a:
        raise AssertionError(f"loss after restore {loss_b!r}, before "
                             f"{loss_a!r}")
    return {"card": smi, "step": state.step, "leaves": len(saved),
            "bytes": nbytes, "save_s": save_s, "restore_s": restore_s,
            "save_gb_per_s": nbytes / save_s / 1e9,
            "restore_gb_per_s": nbytes / restore_s / 1e9,
            "loss_before": loss_a, "loss_after": loss_b}


def _train_route_check(model, batch) -> dict:
    """One typed micro-batch on the card (any groups: its rows embedded
    by ``embed_concat`` at eval patch positions). Layer by layer (under
    no_grad between layers): the six attention gradients through K3-K5
    against autograd through ``rel_attention`` in f32 on the same inputs
    and one seeded upstream gradient (GRAD_REL_TOL); beside them, read and
    not gated, the same gap of the plain bf16 route (autograd through
    ``rel_attention`` in bf16, as the trunk runs it without the kernels),
    so that a reading over the gate shows whether bf16 alone goes as far
    on that micro-batch, and the same gap of the reference algorithm
    (``flash_rel_attention_bwd_plain``: JAX's backward in f32 arithmetic,
    delta from the kernel route's own bf16 output, with its m and l), so
    that a tail of drw and drr shows whether it is K5's or the
    algorithm's. Then the whole
    model's gradient through both routes (attention_impl "auto" and "xla")
    from one generator seed, so that the dropout masks and the patch
    positions are equal: global norms within GRAD_NORM_RTOL, cosine
    similarity at least GRAD_COS_MIN, over the parameters the batch
    reaches (the vision tower only with images)."""
    from bdm_db1_tpu_torch.models.transformer_xl import use_rel_kernel
    from bdm_db1_tpu_torch.ops import flash_rel_attention as fra
    from bdm_db1_tpu_torch.ops.attention import rel_attention, same_length_mask
    from bdm_db1_tpu_torch.ops.positional import relative_positional_embedding

    cfg = model.cfg
    with torch.no_grad():
        h = model.embed_concat(batch, with_targets=False)[0]
    qlen = h.shape[1]
    if not use_rel_kernel(cfg, qlen, qlen, "cuda"):
        raise AssertionError("the training forward does not take K3-K5")
    H, Dh, D = cfg.n_head, cfg.d_head, cfg.n_embed
    mask = same_length_mask(qlen, qlen, cfg.mem_len, device="cuda")
    r = relative_positional_embedding(qlen, D, cfg.effective_clamp_len,
                                      device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    kw = dict(mem_len=cfg.mem_len, same_length=cfg.same_length,
              scale=1.0 / Dh ** 0.5)
    worst = dict.fromkeys(GRAD_NAMES, 0.0)
    plain_worst = dict.fromkeys(GRAD_NAMES, 0.0)
    alg_worst = dict.fromkeys(GRAD_NAMES, 0.0)
    for layer in model.h:
        a = layer.dec_attn
        with torch.no_grad():
            q, k, v = F.linear(h, a.qkv_net.weight.to(h.dtype)).split(D, -1)
            q, k, v = (t.unflatten(-1, (H, Dh)) for t in (q, k, v))
            rk = F.linear(r.to(h.dtype), a.r_net.weight.to(h.dtype)).view(
                qlen, H, Dh)
        ins = [t.detach().requires_grad_(True) for t in
               (q, k, v, rk, a.r_w_bias.float(), a.r_r_bias.float())]
        g = torch.randn(q.shape, device="cuda", generator=gen).to(q.dtype)
        got = torch.autograd.grad(fra.flash_rel_attention(*ins, **kw), ins,
                                  g)
        ref_ins = [t.detach().float().requires_grad_(True) for t in ins]
        ref = torch.autograd.grad(
            rel_attention(*ref_ins, mask, scale=kw["scale"],
                          compute_dtype=torch.float32), ref_ins, g.float())
        plain_ins = [t.detach().requires_grad_(True) for t in ins]
        plain = torch.autograd.grad(
            rel_attention(*plain_ins, mask, scale=kw["scale"],
                          compute_dtype=q.dtype), plain_ins, g)
        with torch.no_grad():
            out, (m, l) = fra.flash_rel_attention(*ins, with_stats=True, **kw)
            alg = fra.flash_rel_attention_bwd_plain(*ins, out, m, l, g, **kw)
            del out, m, l
        for name, x, p, a, y in zip(GRAD_NAMES, got, plain, alg, ref):
            worst[name] = max(worst[name], float(
                (x.float() - y).abs().max() / y.abs().max()))
            plain_worst[name] = max(plain_worst[name], float(
                (p.float() - y).abs().max() / y.abs().max()))
            alg_worst[name] = max(alg_worst[name], float(
                (a.float() - y).abs().max() / y.abs().max()))
        del got, ref, ref_ins, ins, plain, plain_ins, alg
        with torch.no_grad():
            h = layer(h, None, r, mask, True)

    params = list(model.parameters())
    flat = {}
    impl = cfg.attention_impl
    try:
        for route, name in (("auto", "kernel"), ("xla", "plain")):
            cfg.attention_impl = route
            _, loss = model(batch, compute_loss=True, deterministic=False,
                            loss_only=True,
                            generator=torch.Generator(
                                device="cuda").manual_seed(4))
            flat[name] = [None if gr is None else gr.float() for gr in
                          torch.autograd.grad(loss, params,
                                              allow_unused=True)]
            del loss
    finally:
        cfg.attention_impl = impl
    reached = [i for i, g in enumerate(flat["kernel"]) if g is not None]
    if reached != [i for i, g in enumerate(flat["plain"]) if g is not None]:
        raise AssertionError("the two routes reach other parameters")
    flat = {k: [v[i] for i in reached] for k, v in flat.items()}
    dot = sum(float((x.double() * y.double()).sum())
              for x, y in zip(flat["kernel"], flat["plain"]))
    nk = sum(float(x.double().square().sum()) for x in flat["kernel"]) ** 0.5
    npl = sum(float(y.double().square().sum()) for y in flat["plain"]) ** 0.5
    del flat
    out = {"grad_tol": GRAD_REL_TOL, "attn_grad_rel_err": worst,
           "plain_bf16_attn_grad_rel_err": plain_worst,
           "ref_alg_attn_grad_rel_err": alg_worst,
           "params_reached": len(reached), "params": len(params),
           "grad_norm_kernel": nk, "grad_norm_plain": npl,
           "grad_norm_rel_diff": abs(nk - npl) / npl,
           "grad_norm_rtol": GRAD_NORM_RTOL, "grad_cosine": dot / (nk * npl),
           "grad_cosine_min": GRAD_COS_MIN}
    if not (all(v <= GRAD_REL_TOL for v in worst.values())
            and out["grad_norm_rel_diff"] <= GRAD_NORM_RTOL
            and out["grad_cosine"] >= GRAD_COS_MIN):
        raise AssertionError(f"K3-K5 gradients vs rel_attention: {out}")
    return out


EVAL_ENVS = ("halfcheetah-geometry-a-v0", "halfcheetah-geometry-b-v0")
EVAL_TRIALS = 20
EVAL_STEPS = 8


def _register_eval_envs(seed: int, cache_dir=None) -> None:
    """Register EVAL_ENVS (FakeContinuousEnv(17, 6), the serve phases'
    geometry, seeded ``seed`` + 10 i) in this process; with ``cache_dir``,
    write their trajectory caches there too (``save_cache``)."""
    from bdm_db1_tpu_torch.data.rl_dataset import TrajectoryStore
    from bdm_db1_tpu_torch.eval.envs import FakeContinuousEnv, register_env

    for i, name in enumerate(EVAL_ENVS):
        env_fn = functools.partial(FakeContinuousEnv, obs_dim=17, act_dim=6,
                                   seed=seed + 10 * i)
        register_env(name, env_fn)
        if cache_dir is not None:
            TrajectoryStore.from_flat_dataset(
                env_fn().make_dataset(10)).save_cache(cache_dir, name)


def _eval_cfg(cache_dir: str, load_dir: str, save_dir: str):
    """db1_1p2b served in bf16 (weights too) from the checkpoint at
    ``load_dir``: EVAL_ENVS x EVAL_TRIALS in one lockstep cohort,
    EVAL_STEPS env steps, the records to ``save_dir``."""
    from bdm_db1_tpu_torch.core.config import db1_1p2b

    cfg = db1_1p2b()
    cfg.model.param_dtype = "bfloat16"
    cfg.data.rl_dataset_cache_dir = cache_dir
    cfg.train.load_dir, cfg.train.save_dir = load_dir, save_dir
    cfg.eval = dataclasses.replace(
        cfg.eval, env_names=EVAL_ENVS, num_trials=EVAL_TRIALS,
        batched=True, batch_size=len(EVAL_ENVS) * EVAL_TRIALS,
        max_step_size=EVAL_STEPS)
    return cfg


def phase_evaluate_rl(smi: str, ckpt_dir: str, saved_weights: dict,
                      seed: int = 0) -> dict:
    """The RL evaluation driver on the train phase's checkpoint: write the
    two envs' trajectory caches (FakeContinuousEnv(17, 6), the serve
    phases' geometry) with ``save_cache`` and register the envs; read the
    checkpoint once through ``load_params`` into a bf16 model and hold
    every weight to the saved f32 weights cast to its dtype (bf16; the
    positional buffer stays f32); then run
    ``evaluate_rl.main`` on the card (counted): two records of 20 trials
    of 8 steps with finite returns, ``results.output`` with their two
    lines, the checkpoint line in its output, and the K1/K2 launches of
    one 40-row lockstep cohort, derived as the serve phase derives them."""
    from bdm_db1_tpu_torch.data.rl_dataset import build_rl_dataset_from_cache
    from bdm_db1_tpu_torch.eval import evaluate_rl
    from bdm_db1_tpu_torch.eval.decode import build_decoder_for_env
    from bdm_db1_tpu_torch.eval.envs import FakeContinuousEnv
    from bdm_db1_tpu_torch.eval.wrapper import TokenizedEnv
    from bdm_db1_tpu_torch.models.transformer_xl import TransformerXL
    from bdm_db1_tpu_torch.ops import flash_ring_decode as fro
    from bdm_db1_tpu_torch.train import pretrain

    work = tempfile.mkdtemp(prefix="chip_smoke_eval_")
    try:
        cache_dir, out_dir = (os.path.join(work, d) for d in ("rl", "out"))
        _register_eval_envs(seed, cache_dir)
        cfg = _eval_cfg(cache_dir, ckpt_dir, out_dir)
        if not cfg.eval.decode_obs_buckets:
            raise AssertionError("db1_1p2b's eval config leaves the "
                                 "geometry buckets off")

        # what load_params reads, held to the saved weights; the plan
        model = TransformerXL(cfg.model, cfg.vocab, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        source = evaluate_rl.load_params(cfg, model)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        if source != evaluate_rl.FROM_PORT:
            raise AssertionError(f"load_params read {source!r}")
        sd = model.state_dict()
        bad = [n for n, t in saved_weights.items()
               if not torch.equal(sd[n].cpu(), t.to(sd[n].dtype))]
        if bad or sd.keys() != saved_weights.keys():
            raise AssertionError(f"loaded weights differ from the saved "
                                 f"ones cast to the model's dtypes: "
                                 f"{bad[:5]}")
        tok = pretrain.build_tokenizer_suite(cfg)
        tenv = TokenizedEnv(FakeContinuousEnv(obs_dim=17, act_dim=6),
                            build_rl_dataset_from_cache(
                                EVAL_ENVS[0], cache_dir,
                                cfg.model.n_position, tok))
        dec = build_decoder_for_env(model, tenv, pad_buckets="default")
        prompt, _ = tenv.get_prompt(strict_length=True,
                                    rng=np.random.RandomState(0))
        q0 = len(prompt) + dec.obs_length + 1
        slices, widths = _prime_widths(dec, q0)
        A = dec.action_length
        del model, sd, dec
        gc.collect()
        torch.cuda.empty_cache()

        # ---- the main path, counted --------------------------------------
        _reset_launches()
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            res = evaluate_rl.main(cfg, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read_launches()
        # ------------------------------------------------------------------
        sys.stdout.write(out.getvalue())

        L, steps = cfg.model.n_layer, EVAL_STEPS
        want = dict.fromkeys(launches, 0)
        want["flash_ring_decode"] = L * (steps * (A - 1) + slices.count(1))
        want["flash_ring_prime_ap"] = L * (
            steps - 1 + sum(2 <= q <= fro.MAX_PRIME_Q for q in slices))
        if launches != want:
            raise AssertionError(f"kernel launches {launches}, expected "
                                 f"{want}")
        if "restored port checkpoint" not in out.getvalue():
            raise AssertionError("main did not read the port checkpoint")
        if not ([r["env"] for r in res] == list(EVAL_ENVS) and all(
                r["num_trials"] == EVAL_TRIALS and r["length_mean"] == steps
                and np.isfinite(r["return_mean"]) for r in res)):
            raise AssertionError(f"records off: {res}")
        with open(os.path.join(out_dir, "results.output")) as f:
            lines = f.read().splitlines()
        if lines != [json.dumps(r) for r in res]:
            raise AssertionError(f"results.output off: {lines}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    actions = len(EVAL_ENVS) * EVAL_TRIALS * steps
    return {"phase": "evaluate_rl", "config": "db1_1p2b", "dtype": "bfloat16",
            "param_dtype": "bfloat16", "card": smi, "envs": list(EVAL_ENVS),
            "trials": EVAL_TRIALS, "batch": cfg.eval.batch_size,
            "env_steps": steps, "prime_slices": slices,
            "prime_widths": widths,
            "launches": launches, "launches_expected": want,
            "records": res, "load_params_s": load_s, "wall_s": wall,
            "actions_per_sec": actions / wall}


PRETRAIN_ENV = "halfcheetah-geometry-pretrain-v0"
PRETRAIN_ITERS = 6
PRETRAIN_DOCS = 2000
PRETRAIN_TRIALS = 2
PRETRAIN_STEPS = 8
# the synthetic corpus: English-like sentences of 4-14 words from this list
WORDS = tuple((
    "the of and to in is was he for it with as his on be at by had are but "
    "from or have an they which one you were her all she there would their "
    "we him been has when who will more no if out so said what up its about "
    "into than them can only other new some could time these two may then "
    "do first any my now such like our over man me even most made after "
    "also did many before must through back years where much your way well "
    "down should because each just those people how too little state good "
    "very make world still own see men work long get here between both life "
    "being under never day same another know while last might us great old "
    "year off come since against go came right used take three").split())


def _write_corpus(path: str, seed: int) -> int:
    """A jsonl of PRETRAIN_DOCS documents of 5-100 sentences of 4-14 words
    from WORDS, seeded; returns its bytes."""
    rng = np.random.RandomState(seed)
    words = np.asarray(WORDS)
    ends = np.asarray(list(".?!"))
    with open(path, "w") as f:
        for _ in range(PRETRAIN_DOCS):
            n_sent = rng.randint(5, 101)
            lens = rng.randint(4, 15, size=n_sent)
            picks = words[rng.randint(0, len(words), size=int(lens.sum()))]
            marks = ends[rng.choice(3, size=n_sent, p=(0.8, 0.1, 0.1))]
            cuts = np.cumsum(lens)[:-1]
            sents = [" ".join(ws).capitalize() + m
                     for ws, m in zip(np.split(picks, cuts), marks)]
            f.write(json.dumps({"text": " ".join(sents)}) + "\n")
    return os.path.getsize(path)


def _run_pretrain(cfg) -> dict:
    """``pretrain.main(cfg, device="cuda")``, counted: the launches of the
    call, its wall time and peak memory, what it hands the model (each
    batch's groups by their label shapes), the last step's model, step
    function and arguments, and each save with its seconds. Its output is
    written out after the call."""
    from bdm_db1_tpu_torch.train import checkpoint, pretrain, trainer
    from bdm_db1_tpu_torch.train.step import make_train_step

    groups, last, saves, patched = [], {}, [], []
    to_gato_batch = trainer.to_gato_batch
    save = checkpoint.CheckpointManager.save

    def recording_batch(raw, device="cuda"):
        groups.append({m: tuple(f["label"].shape) for m, f in raw.items()})
        return to_gato_batch(raw, device)

    def capturing_step(model, **kw):
        step = make_train_step(model, **kw)
        last["model"], last["step"] = model, step

        def run(state, batch, gen):
            last["args"] = (state, batch, gen)
            return step(state, batch, gen)
        return run

    def timed_save(mgr, step, state, client_state=None):
        t = time.perf_counter()
        save(mgr, step, state, client_state)
        mgr.wait()
        torch.cuda.synchronize()
        saves.append((step, time.perf_counter() - t))

    for obj, name, value in ((trainer, "to_gato_batch", recording_batch),
                             (pretrain, "make_train_step", capturing_step),
                             (checkpoint.CheckpointManager, "save",
                              timed_save)):
        patched.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)
    out = io.StringIO()
    try:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        # ---- the main path, counted --------------------------------------
        _reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            pretrain.main(cfg, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read_launches()
        # ------------------------------------------------------------------
        peak = torch.cuda.max_memory_allocated()
    finally:
        for obj, name, value in reversed(patched):
            setattr(obj, name, value)
        sys.stdout.write(out.getvalue())
    return {"groups": groups, "last": last, "saves": saves,
            "launches": launches, "wall": wall, "peak": peak}


def phase_pretrain(smi: str, seed: int = 0) -> dict:
    """The pretraining driver at db1_1p2b on a 0.5 text / 0.5 RL mixture:
    a seeded synthetic corpus through ``preprocess.main`` (byte tokenizer,
    uint16 ``.bin/.idx``), the HalfCheetah-geometry RL cache written with
    ``save_cache`` and its env registered, then ``pretrain.main(cfg,
    device="cuda")`` (counted): micro-batch 4 x 1024 (2 text rows and 2 RL
    rows) with accum 2 for PRETRAIN_ITERS iterations, the eval hook at the
    last one (the validation loss over one batch, RL rollouts of
    PRETRAIN_TRIALS episodes of PRETRAIN_STEPS steps on the training
    weights) and the final checkpoint. Checks the groups of every batch,
    the launches of K3-K5 (training forwards and backwards, the validation
    forwards) and K1/K2 (the rollouts' plan), finite losses (the first
    within 1.0 of log V, the last below it), the metric keys and the step
    checkpoint. Reads tokens/sec over steps 2-6 and the median step from
    metrics.jsonl, the peak memory, the eval tick and the save. After the
    counted run, on the trained model: the kernel route against the plain
    ring branch layer by layer at B 1 (``_route_check``: the rollouts'
    shape), and one more step on the last batch, profiled (device busy,
    as the ``train`` phase profiles a warmed step)."""
    from types import SimpleNamespace

    from bdm_db1_tpu_torch.core.config import db1_1p2b
    from bdm_db1_tpu_torch.data import preprocess
    from bdm_db1_tpu_torch.data.rl_dataset import (
        TrajectoryStore, build_rl_dataset_from_cache,
    )
    from bdm_db1_tpu_torch.eval.decode import ActionDecoder
    from bdm_db1_tpu_torch.eval.envs import (
        FakeContinuousEnv, make_env, register_env,
    )
    from bdm_db1_tpu_torch.eval.wrapper import TokenizedEnv
    from bdm_db1_tpu_torch.ops import flash_ring_decode as fro
    from bdm_db1_tpu_torch.train import pretrain

    allocated_at_start = torch.cuda.memory_allocated()
    work = tempfile.mkdtemp(prefix="chip_smoke_pretrain_")
    last = {}
    try:
        corpus_json = os.path.join(work, "corpus.jsonl")
        corpus = os.path.join(work, "corpus")
        cache_dir = os.path.join(work, "rl")
        save_dir = os.path.join(work, "run")
        t0 = time.perf_counter()
        json_bytes = _write_corpus(corpus_json, seed)
        gen_s = time.perf_counter() - t0
        with contextlib.redirect_stderr(io.StringIO()):
            pre = preprocess.main(["--input", corpus_json, "--json-key",
                                   "text", "--output-prefix", corpus])

        def env_fn():
            return FakeContinuousEnv(obs_dim=17, act_dim=6, seed=seed + 3)

        register_env(PRETRAIN_ENV, env_fn)
        TrajectoryStore.from_flat_dataset(FakeContinuousEnv(
            obs_dim=17, act_dim=6, episode_len=200,
            seed=999).make_dataset(20)).save_cache(cache_dir, PRETRAIN_ENV)

        cfg = db1_1p2b()
        cfg.data.data_path = ("0.5", corpus, "nlp", "0.5", PRETRAIN_ENV, "rl")
        cfg.data.rl_dataset_cache_dir = cache_dir
        cfg.train = dataclasses.replace(
            cfg.train, micro_batch_size=TRAIN_MICRO,
            global_batch_size=TRAIN_MICRO * TRAIN_ACCUM,
            train_iters=PRETRAIN_ITERS, log_interval=1,
            eval_interval=PRETRAIN_ITERS, eval_iters=1,
            save_interval=PRETRAIN_ITERS + 1, save_dir=save_dir)
        cfg.eval = dataclasses.replace(
            cfg.eval, env_names=(PRETRAIN_ENV,), num_trials=PRETRAIN_TRIALS,
            max_step_size=PRETRAIN_STEPS)

        # the main path, counted
        run = _run_pretrain(cfg)
        groups, last, saves = run["groups"], run["last"], run["saves"]
        launches, wall, peak = run["launches"], run["wall"], run["peak"]

        L = cfg.model.n_layer
        micro = {"rl": TRAIN_MICRO // 2, "nlp": TRAIN_MICRO // 2}
        L_seq = cfg.data.seq_length
        want_train = {m: (TRAIN_ACCUM, c, L_seq) for m, c in micro.items()}
        want_eval = {m: (c, L_seq) for m, c in micro.items()}
        # the Trainer's batches, then evaluate_loss's micro-batches
        if groups != ([want_train] * PRETRAIN_ITERS
                      + [want_eval] * TRAIN_ACCUM):
            raise AssertionError(f"batch groups off: {groups}")
        # the rollouts' plan, as evaluate_rl's: per episode a prompt prime
        # in ring slices, then per env step A - 1 single-token forwards
        # and a deferred [action || obs || sep] prime
        tenv = TokenizedEnv(env_fn(), build_rl_dataset_from_cache(
            PRETRAIN_ENV, cache_dir, cfg.model.n_position,
            pretrain.build_tokenizer_suite(cfg)))
        prompt, _ = tenv.get_prompt(strict_length=True,
                                    rng=np.random.RandomState(cfg.eval.seed))
        q0 = len(prompt) + tenv.obs_length + 1
        slices = ActionDecoder.chunk_plan(
            SimpleNamespace(model=SimpleNamespace(cfg=cfg.model),
                            use_kv_cache=True), q0, 0)[0] or [q0]
        A, steps, n = tenv.action_length, PRETRAIN_STEPS, PRETRAIN_TRIALS
        want = dict.fromkeys(launches, 0)
        fwd = L * TRAIN_ACCUM * PRETRAIN_ITERS
        want["flash_rel_attention"] = fwd + L * TRAIN_ACCUM
        want["flash_rel_attention_bwd_dq"] = fwd
        want["flash_rel_attention_bwd_dkv"] = fwd
        want["flash_ring_decode"] = n * L * (steps * (A - 1)
                                             + slices.count(1))
        want["flash_ring_prime_ap"] = n * L * (
            steps - 1 + sum(2 <= q <= fro.MAX_PRIME_Q for q in slices))
        if launches != want:
            raise AssertionError(f"kernel launches {launches}, expected "
                                 f"{want}")

        recs = [json.loads(line) for line in
                open(os.path.join(save_dir, "metrics.jsonl"))]
        train = [r for r in recs if "train/loss" in r]
        valid = [r for r in recs if "valid/loss" in r]
        log_v = float(np.log(cfg.vocab.layout().total_vocab_size))
        losses = [r["train/loss"] for r in train]
        want_keys = {"valid/loss", f"valid/return/{PRETRAIN_ENV}",
                     f"valid/length/{PRETRAIN_ENV}"}
        # a random init starts near log V; the byte-level text (a few
        # dozen symbols) is learned within the run, so later losses fall
        # well below it
        if not ([r["step"] for r in train] == list(range(1,
                                                         PRETRAIN_ITERS + 1))
                and np.isfinite(losses).all()
                and abs(losses[0] - log_v) <= 1.0 and losses[-1] < losses[0]
                and all("train/tokens_per_sec" in r for r in train)):
            raise AssertionError(f"train records off: {train}")
        if not (len(valid) == 1 and want_keys <= set(valid[0])
                and valid[0]["step"] == PRETRAIN_ITERS
                and np.isfinite(valid[0]["valid/loss"])
                and valid[0][f"valid/length/{PRETRAIN_ENV}"] == steps
                and np.isfinite(valid[0][f"valid/return/{PRETRAIN_ENV}"])):
            raise AssertionError(f"valid records off: {valid}")
        step_dir = os.path.join(save_dir, str(PRETRAIN_ITERS))
        with open(os.path.join(step_dir, "client.json")) as f:
            client = json.load(f)
        if client != {"iteration": PRETRAIN_ITERS} or [
                s for s, _ in saves] != [PRETRAIN_ITERS]:
            raise AssertionError(f"checkpoint off: {client}, saves {saves}")
        ckpt_bytes = _dir_bytes(step_dir)

        # ---- after the counted run: the route at B 1, a warmed step --------
        model, step = last["model"], last["step"]
        routes = _route_check(model, cfg.vocab.layout(), 1, lambda name: (
            TokenizedEnv(make_env(name), build_rl_dataset_from_cache(
                name, cache_dir, cfg.model.n_position,
                pretrain.build_tokenizer_suite(cfg)))),
            [PRETRAIN_ENV], f32_copy=False)
        torch.cuda.empty_cache()
        _reset_launches()
        busy, top, prof_wall, _ = _profile_busy(
            lambda: step(*last["args"]), keep=tuple(ALONE_KERNELS.values()))
        alone = kernel_alone_ms(top, _read_launches())
        del model, step
    finally:
        last.clear()
        shutil.rmtree(work, ignore_errors=True)

    tokens = TRAIN_ACCUM * TRAIN_MICRO * cfg.data.seq_length
    step_s = [tokens / r["train/tokens_per_sec"] for r in train]
    steady = step_s[1:]
    median = float(np.median(steady))
    eval_s = valid[0]["time"] - train[-1]["time"]
    save_s = saves[0][1]
    return {"phase": "pretrain", "config": "db1_1p2b", "dtype": "bfloat16",
            "param_dtype": "float32", "card": smi,
            "data_path": ["0.5", "<corpus> nlp", "0.5", PRETRAIN_ENV, "rl"],
            "micro_batch": micro, "accum": TRAIN_ACCUM,
            "seq_length": cfg.data.seq_length, "iters": PRETRAIN_ITERS,
            "allocated_at_start_gb": allocated_at_start / 1e9,
            "corpus": {"docs": pre["docs"], "tokens": pre["tokens"],
                       "jsonl_bytes": json_bytes, "generate_s": gen_s,
                       "preprocess_s": pre["seconds"],
                       "preprocess_tokens_per_sec":
                           pre["tokens"] / pre["seconds"]},
            "launches": launches, "launches_expected": want,
            "prime_slices": slices, "losses": losses, "log_vocab": log_v,
            "valid": valid[0],
            "tokens_per_sec": tokens * len(steady) / float(sum(steady)),
            "tokens_per_sec_over": "steps 2-%d" % PRETRAIN_ITERS,
            "step_ms_median": median * 1e3,
            "step_ms": [t * 1e3 for t in step_s],
            "profiled_step_ms": prof_wall * 1e3,
            "device_busy_ms": busy * 1e3,
            "device_idle_share": 1.0 - busy / median,
            "top_device_ms": top, "kernel_alone_ms": alone,
            "kernel_vs_plain": routes,
            "max_memory_allocated_gb": peak / 1e9,
            "eval_tick_s": eval_s, "save_s": save_s,
            "checkpoint_bytes": ckpt_bytes,
            "save_gb_per_s": ckpt_bytes / 1e9 / save_s, "wall_s": wall}


VISION_ENV = "fake-image-v0"
VISION_HW = 80              # 5 x 5 patches of 16 a frame
VISION_EPISODES = 12
VISION_EPISODE_LEN = 50
VISION_IMAGES = 8           # inline 224 x 224 images of each of IC and VQA
VISION_ITERS = 6
VISION_TRIALS = 40
VISION_STEPS = 8
# the caption prime: [9 prompt tokens | 196 patches | one EOS]
IC_PRIME_Q = 9 + 196 + 1


def _register_image_env(seed: int) -> None:
    """``fake-image-v0`` at 80 x 80 frames (the JAX registry's is 32)."""
    from bdm_db1_tpu_torch.eval.envs import FakeImageEnv, register_env

    def env_fn():
        return FakeImageEnv(hw=VISION_HW, seed=seed)

    register_env(VISION_ENV, env_fn)


def _write_ic_vqa(work: str, seed: int, size: int, eos: int) -> tuple:
    """A COCO caption JSON and a VQA v2 annotation + question pair with
    VISION_IMAGES inline ``pixels`` images each (CHW, size x size, 3
    decimals), byte-token captions (2 an image, 8-40 tokens, eos-ended),
    questions (5-15 tokens) and answers (1-3 tokens, eos-ended), all from
    ``seed``; returns the two mixture prefixes."""
    rng = np.random.RandomState(seed)

    def images():
        return [{"id": i, "file_name": f"{i}.jpg",
                 "pixels": np.round(rng.rand(3, size, size), 3).tolist()}
                for i in range(VISION_IMAGES)]

    def text(lo, hi):
        return rng.randint(32, 127, rng.randint(lo, hi + 1)).tolist() + [eos]

    prompt_items = [[68, 101, 115, 99, 114, 105, 98, 101, 58], [81, 58],
                    [65, 58]]
    coco = os.path.join(work, "captions.json")
    with open(coco, "w") as f:
        json.dump({"images": images(), "prompt_items": prompt_items,
                   "annotations": [{"image_id": i, "caption": text(8, 40)}
                                   for i in range(VISION_IMAGES)
                                   for _ in range(2)]}, f)
    ann, ques = (os.path.join(work, n) for n in ("vqa_ann.json",
                                                 "vqa_q.json"))
    with open(ann, "w") as f:
        json.dump({"images": images(), "prompt_items": prompt_items,
                   "annotations": [{
                       "question_id": 100 + i, "image_id": i,
                       "answer_type": "other", "question_type": "what",
                       "answers": [{"answer": "x"}],
                       "answer_tokens": [text(1, 3)]}
                       for i in range(VISION_IMAGES)]}, f)
    with open(ques, "w") as f:
        json.dump({"questions": [{"question_id": 100 + i, "image_id": i,
                                  "question_tokens": text(5, 15)[:-1]}
                                 for i in range(VISION_IMAGES)]}, f)
    return f"{work}:{coco}", f"{work}:{ann}:{ques}"


def _vision_profile(model, batch, gen) -> tuple:
    """The vision tower's forward and backward over a step's frames, as
    the step runs them (per micro-batch, each image group, training patch
    positions), profiled alone: (device busy s, top kernels by name)."""
    from bdm_db1_tpu_torch.train.step import accum_steps, micro_batch

    enc = model.vision_encoder
    params = list(enc.parameters())

    def run():
        for a in range(accum_steps(batch)):
            for sub in micro_batch(batch, a).values():
                images = getattr(sub, "images", None)
                if images is None:
                    continue
                if images.dim() == 5:       # RL rows: [B, T, H, W, C]
                    images = images.flatten(0, 1)
                out = enc(images, False, gen)
                torch.autograd.grad(out.float().sum(), params)

    run()                                   # warm-up (cuDNN plans)
    busy, top, _, _ = _profile_busy(run)
    return busy, top


def phase_pretrain_vision(smi: str, vis_dir: str, saved_weights: dict,
                          seed: int = 0) -> dict:
    """The pretraining driver at db1_1p2b on a four-group mixture, all
    data made from ``seed`` under ``vis_dir``: 0.4 RL tensor rows (the
    pretrain phase's HalfCheetah-geometry cache), 0.2 image RL (FakeImageEnv
    trajectories of 3 x 80 x 80 frames, 25 patches a frame, written with
    ``save_cache`` as ``fake-image-v0``), 0.2 captioning (a COCO JSON of 8
    inline 224 x 224 images, 196 patches, caption budget 829) and 0.2 VQA
    (8 inline images). ``pretrain.main`` (counted): micro-batch 4 x 1024 (a
    row of each group), accum 2, VISION_ITERS iterations, the validation
    loss over one batch at the last, the final checkpoint (served by
    ``evaluate_rl_image``; a host copy of its weights in
    ``saved_weights``). Checks every batch's groups, the launches of K3-K5
    (24 x 2 x 6 training forwards and backwards, 24 x 2 validation
    forwards; no rollout, so no K1/K2), finite losses, the metric keys and
    the checkpoint, and that the phase imported no PIL. After the counted
    run: the gradient route check of the ``train`` phase on the first
    micro-batch of the last step, the last step profiled again, and the
    vision tower's forward and backward over that step's frames profiled
    alone (its share of the step's device time)."""
    import importlib.util

    from bdm_db1_tpu_torch.core.config import db1_1p2b
    from bdm_db1_tpu_torch.data.coco import ic_caption_budget
    from bdm_db1_tpu_torch.data.rl_dataset import TrajectoryStore
    from bdm_db1_tpu_torch.eval.envs import FakeContinuousEnv, FakeImageEnv
    from bdm_db1_tpu_torch.tokenizers.text import ByteTextTokenizer
    from bdm_db1_tpu_torch.train.step import micro_batch

    pil_before = "PIL" in sys.modules
    cache_dir = os.path.join(vis_dir, "rl")
    save_dir = os.path.join(vis_dir, "run")
    cfg = db1_1p2b()
    size, patch = cfg.vision.image_size, cfg.vision.patch_size
    t0 = time.perf_counter()
    TrajectoryStore.from_flat_dataset(FakeContinuousEnv(
        obs_dim=17, act_dim=6, episode_len=200,
        seed=999).make_dataset(20)).save_cache(cache_dir, PRETRAIN_ENV)
    TrajectoryStore.from_flat_dataset(FakeImageEnv(
        hw=VISION_HW, episode_len=VISION_EPISODE_LEN,
        seed=seed + 5).make_dataset(VISION_EPISODES)).save_cache(
        cache_dir, VISION_ENV)
    _register_image_env(seed + 6)
    ic, vqa = _write_ic_vqa(vis_dir, seed, size,
                            ByteTextTokenizer().eos_token_id)
    data_s = time.perf_counter() - t0

    cfg.data.data_path = ("0.4", PRETRAIN_ENV, "rl", "0.2", VISION_ENV, "rl",
                          "0.2", ic, "ic", "0.2", vqa, "vqa")
    cfg.data.rl_dataset_cache_dir = cache_dir
    cfg.train = dataclasses.replace(
        cfg.train, micro_batch_size=TRAIN_MICRO,
        global_batch_size=TRAIN_MICRO * TRAIN_ACCUM,
        train_iters=VISION_ITERS, log_interval=1,
        eval_interval=VISION_ITERS, eval_iters=1,
        save_interval=VISION_ITERS + 1, save_dir=save_dir)
    cfg.eval = dataclasses.replace(cfg.eval, env_names=())
    if cfg.eval.ic_vqa_num_samples < VISION_IMAGES:
        raise AssertionError("the default eval.ic_vqa_num_samples does not "
                             "reach every image")
    run = _run_pretrain(cfg)
    last = run["last"]
    try:
        L, L_seq = cfg.model.n_layer, cfg.data.seq_length
        # a transition: the frame's patch slots, sep, one action token
        trans = (VISION_HW // patch) ** 2 + 2
        frames = (L_seq + trans - 1) // trans
        img_group = f"rl_img{frames}x{VISION_HW}x{VISION_HW}x3"
        names = ("rl", "ic", "vqa", img_group)
        want_groups = ([{m: (TRAIN_ACCUM, 1, L_seq) for m in names}]
                       * VISION_ITERS + [{m: (1, L_seq) for m in names}]
                       * TRAIN_ACCUM)
        if run["groups"] != want_groups:
            raise AssertionError(f"batch groups off: {run['groups'][:2]}")
        launches = run["launches"]
        want = dict.fromkeys(launches, 0)
        fwd = L * TRAIN_ACCUM * VISION_ITERS
        from bdm_db1_tpu_torch.eval.evaluate_ic import MAX_CAPTION_TOKENS
        from bdm_db1_tpu_torch.eval.evaluate_vqa import MAX_ANSWER_TOKENS
        # the eval tick: the validation forwards, then one caption and one
        # VQA batch of VISION_IMAGES rows, each a prime (K3) and a ring step
        # a further token (K1)
        want["flash_rel_attention"] = fwd + L * TRAIN_ACCUM + L * 2
        want["flash_rel_attention_bwd_dq"] = fwd
        want["flash_rel_attention_bwd_dkv"] = fwd
        want["flash_ring_decode"] = L * (MAX_CAPTION_TOKENS - 1
                                         + MAX_ANSWER_TOKENS - 1)
        if launches != want:
            raise AssertionError(f"kernel launches {launches}, expected "
                                 f"{want}")
        recs = [json.loads(line) for line in
                open(os.path.join(save_dir, "metrics.jsonl"))]
        train = [r for r in recs if "train/loss" in r]
        valid = [r for r in recs if "valid/loss" in r]
        losses = [r["train/loss"] for r in train]
        log_v = float(np.log(cfg.vocab.layout().total_vocab_size))
        if not ([r["step"] for r in train] == list(
                range(1, VISION_ITERS + 1)) and np.isfinite(losses).all()
                and abs(losses[0] - log_v) <= 1.0
                and all("train/tokens_per_sec" in r for r in train)):
            raise AssertionError(f"train records off: {train}")
        if not (len(valid) == 1 and valid[0]["step"] == VISION_ITERS
                and np.isfinite(valid[0]["valid/loss"])):
            raise AssertionError(f"valid records off: {valid}")
        caption_keys = {f"valid/ic0/{k}" for k in (
            "Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "ROUGE_L", "CIDEr")}
        vqa_keys = {"valid/vqa0/vqa_accuracy", "valid/vqa0/num_evaluated"}
        tick = {k: v for k, v in valid[0].items()
                if k.startswith(("valid/ic", "valid/vqa"))}
        if not (tick.keys() == caption_keys | vqa_keys
                and np.isfinite(list(tick.values())).all()
                and tick["valid/vqa0/num_evaluated"] == VISION_IMAGES):
            raise AssertionError(f"caption/VQA metrics off: {tick}")
        with open(os.path.join(save_dir, str(VISION_ITERS),
                               "client.json")) as f:
            if json.load(f) != {"iteration": VISION_ITERS}:
                raise AssertionError("checkpoint client state off")
        pil_imported = "PIL" in sys.modules and not pil_before
        if pil_imported:
            raise AssertionError("the phase imported PIL")

        # ---- after the counted run ---------------------------------------
        model, step = last["model"], last["step"]
        state, batch, _ = last["args"]
        saved_weights.update({n: p.to("cpu", copy=True)
                              for n, p in model.state_dict().items()})
        torch.cuda.empty_cache()
        routes = _train_route_check(model, micro_batch(batch, 0))
        torch.cuda.empty_cache()
        _reset_launches()
        busy, top, prof_wall, _ = _profile_busy(
            lambda: step(*last["args"]), keep=tuple(ALONE_KERNELS.values()))
        alone = kernel_alone_ms(top, _read_launches())
        gen = torch.Generator(device="cuda").manual_seed(seed + 7)
        vis_busy, vis_top = _vision_profile(model, batch, gen)
        captions = _caption_check(model, cfg, ic)
        del model, step, state, batch
    finally:
        last.clear()
        gc.collect()
        torch.cuda.empty_cache()

    tokens = TRAIN_ACCUM * TRAIN_MICRO * L_seq
    step_s = [tokens / r["train/tokens_per_sec"] for r in train]
    median = float(np.median(step_s[1:]))
    return {"phase": "pretrain_vision", "config": "db1_1p2b",
            "dtype": "bfloat16", "param_dtype": "float32", "card": smi,
            "data_path": ["0.4", PRETRAIN_ENV, "rl", "0.2", VISION_ENV, "rl",
                          "0.2", "<coco> ic", "0.2", "<vqa> vqa"],
            "groups": list(names), "frame_hw": VISION_HW,
            "patches_a_frame": (VISION_HW // patch) ** 2,
            "ic_patches": (size // patch) ** 2,
            "ic_caption_budget": ic_caption_budget(L_seq, size, patch),
            "micro_batch": TRAIN_MICRO, "accum": TRAIN_ACCUM,
            "seq_length": L_seq, "iters": VISION_ITERS, "data_s": data_s,
            "launches": launches, "launches_expected": want,
            "losses": losses, "log_vocab": log_v, "valid": valid[0],
            "tokens_per_sec": tokens * len(step_s[1:]) / sum(step_s[1:]),
            "tokens_per_sec_over": "steps 2-%d" % VISION_ITERS,
            "step_ms_median": median * 1e3,
            "step_ms": [t * 1e3 for t in step_s],
            "profiled_step_ms": prof_wall * 1e3,
            "device_busy_ms": busy * 1e3,
            "device_idle_share": 1.0 - busy / median,
            "top_device_ms": top, "kernel_alone_ms": alone,
            "vision_busy_ms": vis_busy * 1e3,
            "vision_share_of_step": vis_busy / busy,
            "vision_top_device_ms": vis_top,
            "gradient_routes": routes, "eval_tick_metrics": tick,
            "captions": captions,
            "max_memory_allocated_gb": run["peak"] / 1e9,
            "save_s": run["saves"][0][1],
            "pillow_importable": importlib.util.find_spec("PIL") is not None,
            "pil_imported": pil_imported, "wall_s": run["wall"]}


@torch.no_grad()
def _caption_check(model, cfg, ic_prefix: str) -> dict:
    """The eval tick's caption generator on the trained model, outside the
    counted run: VISION_IMAGES captions of the IC valid split, warmed, then
    timed with their launches (one K3 prime, a K1 step per further token,
    24 layers each); then the same chain through the plain routes
    (``decode_flash`` "off": the plain ring branch; ``attention_impl``
    "xla": rel_attention) and the share of equal tokens. Both routes run
    in bf16 and a greedy chain follows its first differing token, so the
    share is read, not gated."""
    from bdm_db1_tpu_torch.data.vit_dataset import get_ic_coco_dataset
    from bdm_db1_tpu_torch.eval.evaluate_ic import CaptionGenerator
    from bdm_db1_tpu_torch.tokenizers.text import ByteTextTokenizer

    root, ann = ic_prefix.split(":")
    eos = ByteTextTokenizer().eos_token_id
    ds = get_ic_coco_dataset(
        root, ann, n_position=cfg.model.n_position,
        image_size=cfg.vision.image_size, patch_size=cfg.vision.patch_size,
        eos_token_id=eos, train=False)
    items = [ds.dataset[i] for i in range(VISION_IMAGES)]
    prompt = np.stack([it["prompt"] for it in items])
    images = np.stack([np.transpose(it["img"], (1, 2, 0)) for it in items])
    seed = np.full((len(items), 1), eos, np.int64)
    gen = CaptionGenerator(model, cfg.vocab.layout(), eos)
    gen.generate_tokens(prompt, images, seed)          # warm-up
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    toks = gen.generate_tokens(prompt, images, seed)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_launches()
    L, n = cfg.model.n_layer, gen.max_tokens
    want = dict.fromkeys(launches, 0)
    want["flash_rel_attention"] = L
    want["flash_ring_decode"] = L * (n - 1)
    if launches != want:
        raise AssertionError(f"caption launches {launches}, expected {want}")
    plain = _plain_routes(model, lambda: gen.generate_tokens(
        prompt, images, seed))
    q = prompt.shape[1] + (cfg.vision.image_size
                           // cfg.vision.patch_size) ** 2 + 1
    ins = [torch.as_tensor(a, dtype=dt, device="cuda") for a, dt in (
        (prompt, torch.int64), (images, torch.float32), (seed, torch.int64))]
    routes = _generator_route_check(model, model.embed_ic(*ins), toks[:, :1])
    return {"batch": len(items), "prime_q": q, "tokens": n,
            "tokens_per_sec": len(items) * n / wall, "wall_s": wall,
            "k3_launches_per_prime": launches["flash_rel_attention"],
            "k1_launches_per_token": launches["flash_ring_decode"] / (n - 1),
            "equal_token_share_vs_plain": float(
                (toks == plain).float().mean()),
            "equal_first_token_share_vs_plain": float(
                (toks[:, 0] == plain[:, 0]).float().mean()),
            "kernel_vs_plain": routes}


@torch.no_grad()
def _generator_route_check(model, h, tok) -> dict:
    """The generators' two forwards layer by layer, each layer's attention
    through the kernel route and the plain route on the same input (gated
    at ATTN_REL_TOL, as the serve's route check): the embedded prefix h
    [B, q, D] over the zero aligned cache (``kv_forward``: K3 against
    ``rel_attention``), then one text token tok [B, 1] over the ring the
    kernel route's prefix leaves (K1 against the plain ring branch)."""
    from bdm_db1_tpu_torch.models.transformer_xl import use_rel_kernel
    from bdm_db1_tpu_torch.ops.attention import causal_mask, same_length_mask

    cfg = model.cfg
    B, q = h.shape[:2]
    M = cfg.mem_len
    cache = model.init_kv_cache(B)
    rk = model.precompute_rk(q)
    _, ring = model.kv_forward(h, cache, rk)
    mask = (same_length_mask(q, M + q, M, device="cuda") if cfg.same_length
            else causal_mask(q, M + q, device="cuda"))
    x = model.embed_nlp(tok)
    mask1, mask1_s = model.ring_masks(1, ring["cursor"], "cuda")
    if not (use_rel_kernel(cfg, q, M + q, "cuda")
            and model.use_kernels(1, ring)):
        raise AssertionError("the generators' forwards do not take K3 and "
                             "K1")

    def rel(a, b):
        return float((a.float() - b.float()).abs().max()
                     / b.float().abs().max())

    rk1 = model.precompute_rk(1)
    prime, step = [], []
    for li, layer in enumerate(model.h):
        a = layer.dec_attn
        kv = (rk[li], cache["k"][li], cache["v"][li], mask)
        attn = a.attend_kv(h, *kv, True)[0]
        prime.append(rel(attn, a.attend_kv(h, *kv, False)[0]))
        h = layer.pos_ff(a._residual(h, attn))
        args = (rk1[li], ring, li, mask1, mask1_s)
        attn = a.attend_ring(x, *args, True)[0]
        step.append(rel(attn, a.attend_ring(x, *args, False)[0]))
        x = layer.forward_ring(x, *args, True)[0]
    rec = {"attn_tol": ATTN_REL_TOL, "prime_q": q,
           "prime_attn_rel_err_max": max(prime),
           "step_attn_rel_err_max": max(step)}
    if not max(prime + step) <= ATTN_REL_TOL:
        raise AssertionError(f"generator kernel route vs plain: {rec}")
    return rec


def _plain_routes(model, fn, keep=()):
    """fn() with the model on its plain routes (``decode_flash`` "off",
    ``attention_impl`` "xla"), counted to launch no kernel but those named
    in ``keep``."""
    cfg = model.cfg
    saved = cfg.decode_flash, cfg.attention_impl
    cfg.decode_flash, cfg.attention_impl = "off", "xla"
    try:
        _reset_launches()
        out = fn()
        torch.cuda.synchronize()
        if any(v for k, v in _read_launches().items() if k not in keep):
            raise AssertionError(f"the plain routes launched kernels: "
                                 f"{_read_launches()}")
    finally:
        cfg.decode_flash, cfg.attention_impl = saved
    return out


ALIGNED_B = 4


@torch.no_grad()
def _aligned_prime_check(model, tenvs) -> dict:
    """The realigned one-shot prime on the card (``decode_rl_kv``, which
    the decoder takes for a prime longer than mem_len that
    ``_image_chunk_plan`` cannot cut): the expert-prompt image prime whole,
    over a ring that the sliced first prime filled, rotated to age order.
    Each layer's attention through K3 (``attend_kv``, the kernel route) is
    held against ``rel_attention`` on the same input, and so are the logits
    after the last layer run both ways, within the serve route check's
    limits. Then ``_prime_aligned`` as the decoder calls it: one K3 launch a
    layer, logits equal to the layer-by-layer run's within LOGIT_REL_TOL,
    the new cache aligned at cursor 0."""
    from bdm_db1_tpu_torch.data.packing import action_flags_and_position_ids
    from bdm_db1_tpu_torch.eval.decode import (
        _prime_aligned, build_decoder_for_env,
    )
    from bdm_db1_tpu_torch.models.transformer_xl import use_rel_kernel
    from bdm_db1_tpu_torch.ops import flash_rel_attention as fra
    from bdm_db1_tpu_torch.ops.attention import causal_mask, same_length_mask

    cfg = model.cfg
    B, M = len(tenvs), cfg.mem_len
    dec = build_decoder_for_env(model, tenvs[0])
    rng = np.random.RandomState(11)
    sep = [tenvs[0].separator_id]
    starts, frames = [], []
    for t in tenvs:
        prompt, prompt_img = t.get_prompt(strict_length=True, rng=rng)
        obs, img, _ = t.reset()
        starts.append(np.concatenate([prompt, obs, sep]))
        frames.append(np.concatenate([prompt_img, img]))
    starts, frames = np.stack(starts), np.stack(frames)
    _, ring = dec.decode(starts, dec.init_mems(B), prime_images=frames,
                         defer_last=True)
    q = starts.shape[1]
    _, p = action_flags_and_position_ids(q, dec.obs_length,
                                         dec.action_length, 0)
    tok = torch.as_tensor(starts, device="cuda")
    pos = torch.as_tensor(np.broadcast_to(p, (B, q)).copy(), device="cuda")
    img = torch.as_tensor(frames, dtype=torch.float32, device="cuda")
    if not (q > M and use_rel_kernel(cfg, q, M + q, "cuda")):
        raise AssertionError(f"a {q}-token prime over {M} rows is not on "
                             f"the K3 route")
    aligned = model.align_ring_cache(ring)
    rk = model.precompute_rk(q)
    mask = (same_length_mask(q, M + q, M, device="cuda") if cfg.same_length
            else causal_mask(q, M + q, device="cuda"))

    def rel(a, b):
        return float((a.float() - b.float()).abs().max()
                     / b.float().abs().max())

    h = model.embed_rl(tok, pos, img)
    attn_err = []
    for li, layer in enumerate(model.h):
        kv = (rk[li], aligned["k"][li], aligned["v"][li], mask)
        attn = layer.dec_attn.attend_kv(h, *kv, True)[0]
        attn_p = layer.dec_attn.attend_kv(h, *kv, False)[0]
        attn_err.append(rel(attn, attn_p))
        del attn, attn_p
        h_in = h
        h = layer.forward_kv(h, *kv, True)[0]
    logits = model.logits(h[:, -1])
    logits_p = model.logits(layer.forward_kv(h_in, *kv, False)[0][:, -1])
    before = fra.LAUNCHES["flash_rel_attention"]
    logits_d, new = _prime_aligned(model, tok, pos, ring, rk, img)
    torch.cuda.synchronize()
    out = {"q": q, "frames": frames.shape[1], "batch": B, "klen": M + q,
           "attn_tol": ATTN_REL_TOL, "logit_tol": LOGIT_REL_TOL,
           "attn_rel_err_max": max(attn_err),
           "last_layer_logits_rel_err": rel(logits, logits_p),
           "prime_aligned_vs_layers_rel_err": rel(logits_d, logits),
           "k3_launches": fra.LAUNCHES["flash_rel_attention"] - before,
           "k3_launches_expected": cfg.n_layer}
    if not (torch.isfinite(logits_d).all()
            and out["attn_rel_err_max"] <= ATTN_REL_TOL
            and out["last_layer_logits_rel_err"] <= LOGIT_REL_TOL
            and out["prime_aligned_vs_layers_rel_err"] <= LOGIT_REL_TOL
            and out["k3_launches"] == cfg.n_layer
            and new["cursor"] == 0
            and new["k"].shape == ring["k"].shape == new["v"].shape):
        raise AssertionError(f"the realigned prime on the card: {out}")
    return out


def phase_evaluate_rl_image(smi: str, vis_dir: str, saved_weights: dict,
                            seed: int = 0) -> dict:
    """Needs ``pretrain_vision``: ``evaluate_rl.main`` on the card serving
    its checkpoint as db1_1p2b in bf16 on ``fake-image-v0`` (80 x 80
    frames, one discrete action token), VISION_TRIALS episodes of
    VISION_STEPS steps in one lockstep cohort with an expert prompt, whose
    first prime ``_image_chunk_plan`` cuts into transition-aligned slices.
    Before the counted run: ``load_params`` reads the port checkpoint
    (every weight the saved one cast to bf16) and the serve route check
    runs on this geometry at B 40 (a 27-token image prime on K2 and a q =
    1 forward on K1, each layer against the plain ring branch), and so
    does the realigned one-shot prime's (:func:`_aligned_prime_check`, K3
    against ``rel_attention``). Checks the
    records (finite returns, VISION_STEPS steps), ``results.output``, the
    K1/K2 launches derived from the slice plan (with one action token the
    deferred token rides in the next prime: no q = 1 forward, so K1 0) and
    that the phase imported no PIL."""
    from bdm_db1_tpu_torch.core.config import db1_1p2b
    from bdm_db1_tpu_torch.data.rl_dataset import build_rl_dataset_from_cache
    from bdm_db1_tpu_torch.eval import evaluate_rl
    from bdm_db1_tpu_torch.eval.decode import build_decoder_for_env
    from bdm_db1_tpu_torch.eval.envs import make_env
    from bdm_db1_tpu_torch.eval.wrapper import TokenizedEnv
    from bdm_db1_tpu_torch.models.transformer_xl import TransformerXL
    from bdm_db1_tpu_torch.ops import flash_ring_decode as fro
    from bdm_db1_tpu_torch.train import pretrain

    pil_before = "PIL" in sys.modules
    cache_dir = os.path.join(vis_dir, "rl")
    out_dir = os.path.join(vis_dir, "out")
    _register_image_env(seed + 6)
    cfg = db1_1p2b()
    cfg.model.param_dtype = "bfloat16"
    cfg.data.rl_dataset_cache_dir = cache_dir
    cfg.train.load_dir = os.path.join(vis_dir, "run")
    cfg.train.save_dir = out_dir
    cfg.eval = dataclasses.replace(
        cfg.eval, env_names=(VISION_ENV,), num_trials=VISION_TRIALS,
        batched=True, batch_size=VISION_TRIALS,
        max_step_size=VISION_STEPS)

    model = TransformerXL(cfg.model, cfg.vocab, vision=cfg.vision,
                          device="cuda")
    if evaluate_rl.load_params(cfg, model) != evaluate_rl.FROM_PORT:
        raise AssertionError("load_params did not read the port checkpoint")
    sd = model.state_dict()
    bad = [n for n, t in saved_weights.items()
           if not torch.equal(sd[n].cpu(), t.to(sd[n].dtype))]
    if bad or sd.keys() != saved_weights.keys():
        raise AssertionError(f"loaded weights differ from the saved ones: "
                             f"{bad[:5]}")
    del sd
    tok = pretrain.build_tokenizer_suite(cfg)

    def make_tenv(name):
        return TokenizedEnv(make_env(name), build_rl_dataset_from_cache(
            name, cache_dir, cfg.model.n_position, tok))

    tenv = make_tenv(VISION_ENV)
    dec = build_decoder_for_env(model, tenv, pad_buckets="default")
    prompt, prompt_img = tenv.get_prompt(strict_length=True,
                                         rng=np.random.RandomState(0))
    q0 = len(prompt) + dec.obs_length + 1
    n0 = len(prompt_img) + 1
    frames = dec.chunk_plan(q0, 0, n0)[1]
    slices, widths = _prime_widths(dec, q0, n0)
    if not (len(slices) > 1 and sum(frames) == n0):
        raise AssertionError(f"the first prime ({q0} tokens, {n0} frames) "
                             f"is not sliced: {slices}")
    A = dec.action_length
    routes = _route_check(model, cfg.vocab.layout(), VISION_TRIALS,
                          make_tenv, [VISION_ENV] * VISION_TRIALS,
                          f32_copy=False)
    aligned = _aligned_prime_check(
        model, [make_tenv(VISION_ENV) for _ in range(ALIGNED_B)])
    del model, dec
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the main path, counted ------------------------------------------
    _reset_launches()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        res = evaluate_rl.main(cfg, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_launches()
    # ----------------------------------------------------------------------
    sys.stdout.write(out.getvalue())

    L, steps = cfg.model.n_layer, VISION_STEPS
    want = dict.fromkeys(launches, 0)
    want["flash_ring_decode"] = L * (steps * (A - 1) + slices.count(1))
    want["flash_ring_prime_ap"] = L * (
        steps - 1 + sum(2 <= q <= fro.MAX_PRIME_Q for q in slices))
    if launches != want:
        raise AssertionError(f"kernel launches {launches}, expected {want}")
    if "restored port checkpoint" not in out.getvalue():
        raise AssertionError("main did not read the port checkpoint")
    if not (len(res) == 1 and res[0]["env"] == VISION_ENV
            and res[0]["num_trials"] == VISION_TRIALS
            and res[0]["length_mean"] == steps
            and np.isfinite(res[0]["return_mean"])):
        raise AssertionError(f"records off: {res}")
    with open(os.path.join(out_dir, "results.output")) as f:
        if f.read().splitlines() != [json.dumps(r) for r in res]:
            raise AssertionError("results.output off")
    pil_imported = "PIL" in sys.modules and not pil_before
    if pil_imported:
        raise AssertionError("the phase imported PIL")
    actions = VISION_TRIALS * steps
    return {"phase": "evaluate_rl_image", "config": "db1_1p2b",
            "dtype": "bfloat16", "param_dtype": "bfloat16", "card": smi,
            "env": VISION_ENV, "frame_hw": VISION_HW,
            "obs_tokens": tenv.obs_length, "action_tokens": A,
            "trials": VISION_TRIALS, "batch": cfg.eval.batch_size,
            "env_steps": steps, "first_prime": {"q": q0, "frames": n0},
            "prime_slices": slices, "prime_widths": widths,
            "slice_frames": list(frames),
            "launches": launches, "launches_expected": want,
            "kernel_vs_plain": routes, "aligned_prime": aligned,
            "records": res, "wall_s": wall,
            "actions_per_sec": actions / wall,
            "pil_imported": pil_imported}


GEN_B = 8            # the eval config's ic_vqa_batch_size
GEN_PROMPT = 64
GEN_TOKENS = 32


def phase_generate(smi: str, seed: int = 0) -> dict:
    """Text generation at db1_1p2b in bf16 (random weights from ``seed``):
    ``TextGenerator`` on GEN_B byte-token prompts of GEN_PROMPT tokens (a
    seeded synthetic text), GEN_TOKENS greedy tokens each. Warmed once,
    then counted: the prompt over the aligned cache (K3: a prompt longer
    than the ring kernels' 32 rows), then a ring step a further token (K1),
    24 layers each. Checks the launches, the shape and that every token is
    a text id; then the same chain through the plain routes
    (``decode_flash`` "off", ``attention_impl`` "xla"): the share of equal
    tokens, read, not gated (bf16 both ways; a greedy chain follows its
    first differing token). Reads the generated tokens/sec."""
    from bdm_db1_tpu_torch.core.config import db1_1p2b
    from bdm_db1_tpu_torch.eval.generate import TextGenerator
    from bdm_db1_tpu_torch.models.transformer_xl import TransformerXL
    from bdm_db1_tpu_torch.tokenizers.text import ByteTextTokenizer

    cfg = db1_1p2b()
    cfg.model.param_dtype = "bfloat16"
    model = TransformerXL(cfg.model, cfg.vocab, vision=cfg.vision,
                          device="cuda", generator=torch.Generator(
                              device="cuda").manual_seed(seed))
    layout = cfg.vocab.layout()
    tok = ByteTextTokenizer()
    rng = np.random.RandomState(seed)
    texts = [" ".join(rng.choice(WORDS, 40)) for _ in range(GEN_B)]
    prompts = np.stack([tok.encode(t)[:GEN_PROMPT] for t in texts])
    if prompts.shape != (GEN_B, GEN_PROMPT):
        raise AssertionError(f"prompts {prompts.shape}")
    gen = TextGenerator(model, layout, tok.eos_token_id,
                        max_tokens=GEN_TOKENS)
    gen.generate_tokens(prompts)                       # warm-up
    torch.cuda.synchronize()

    # ---- the main path, counted ------------------------------------------
    _reset_launches()
    t0 = time.perf_counter()
    toks = gen.generate_tokens(prompts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_launches()
    # ----------------------------------------------------------------------
    L = cfg.model.n_layer
    want = dict.fromkeys(launches, 0)
    want["flash_rel_attention"] = L
    want["flash_ring_decode"] = L * (GEN_TOKENS - 1)
    if launches != want:
        raise AssertionError(f"kernel launches {launches}, expected {want}")
    if toks.shape != (GEN_B, GEN_TOKENS) or not bool(
            (toks < layout.text_vocab_size).all()):
        raise AssertionError(f"generated tokens off: {toks.shape}, "
                             f"{int(toks.max())}")
    plain = _plain_routes(model, lambda: gen.generate_tokens(prompts))
    prompts_t = torch.as_tensor(prompts, device="cuda")
    routes = _generator_route_check(model, model.embed_nlp(prompts_t),
                                    toks[:, :1])
    out = gen.generate(prompts)
    return {"phase": "generate", "config": "db1_1p2b", "dtype": "bfloat16",
            "param_dtype": "bfloat16", "card": smi, "batch": GEN_B,
            "prompt_tokens": GEN_PROMPT, "new_tokens": GEN_TOKENS,
            "launches": launches, "launches_expected": want,
            "k3_launches_per_prompt": launches["flash_rel_attention"],
            "k1_launches_per_token": launches["flash_ring_decode"]
            / (GEN_TOKENS - 1),
            "wall_s": wall, "tokens_per_sec": GEN_B * GEN_TOKENS / wall,
            "equal_token_share_vs_plain": float(
                (toks == plain).float().mean()),
            "equal_first_token_share_vs_plain": float(
                (toks[:, 0] == plain[:, 0]).float().mean()),
            "kernel_vs_plain": routes,
            "sample": tok.decode(out[0])}


# ---- speculative serving, text observations, stateless decode ------------

SPEC_S = 5                     # guesses: the HalfCheetah geometry's 6 - 1
SPEC_PRIME_Q = 24 + SPEC_S     # [6 deferred || 17 obs || sep] + guesses
SPEC_STEPS = 8
SPEC_INT8_STEPS = 4
SPEC_TURNS = ("speculative", "classic", "classic", "speculative")
SPEC_TURN_STEPS = 8
SPEC_ADAPTIVE_STEPS = 8
# The speculative decoder's actions against the classic decoder's from one
# primed cache, SPEC_CHECK_B envs over SPEC_CHECK_STEPS env steps, the envs
# stepped by the classic actions (:func:`_spec_vs_classic`). Both decoders
# are greedy over the same keys; their candidates come from forwards of
# other shapes (29 and 5 rows against 1), so they differ by rounding.
# - Free-running (the speculative decoder carries its own blocks), on an
#   f32 copy of the weights through the plain routes: at least
#   SPEC_ACTION_SHARE of the tokens equal (f32 flips an argmax only at a
#   near-exact tie). This holds the decoder's logic over a chain.
# - Teacher-forced (the speculative decoder is fed the classic block as
#   its deferred carry and its guesses, so both caches hold the same
#   tokens and no difference carries into the next step), on the served
#   weights: through the kernel route (K2 or K7) and through the plain
#   ring branch (``decode_flash`` "off"). In bf16 the random weights'
#   logits are flat enough that the roundings of other shapes flip
#   argmaxes at either route (on an H100 both read 0.2-0.35 of the tokens
#   equal), so the kernel route's share is held to the plain route's: at
#   least that less SPEC_ROUTE_MARGIN (about two standard deviations of
#   the difference of two such shares over 8 x 4 steps), for dim 0 and for
#   the later dims apart. A wrong guess row, mask or merge in the kernel
#   route makes the later dims differ nearly always.
SPEC_ACTION_SHARE = 0.9
SPEC_ROUTE_MARGIN = 0.1
SPEC_CHECK_B = 8
SPEC_CHECK_STEPS = 4


@contextlib.contextmanager
def _model_flags(model, **flags):
    """Decoders built inside see ``model.cfg`` with ``flags`` set (the
    decode mode is read when a decoder is built)."""
    saved = {k: getattr(model.cfg, k) for k in flags}
    for k, v in flags.items():
        setattr(model.cfg, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(model.cfg, k, v)


def _spec_widths(dec, q: int, lead: int) -> list:
    """The ring calls of a speculative decode's q-token prime (``lead``
    deferred tokens first): their widths, the last one with the guesses
    when they ride it."""
    widths, frames, real = dec.prime_plan(q, lead, speculate=True)
    widths, _, tail = dec.spec_plan(widths, frames, real)
    if tail:
        widths[-1] += dec.action_length - 1
    return widths


def _f32_copy(model):
    """The model's weights in an f32 model on the card (the plain routes
    only: the ring kernels take bf16 and int8 caches, K3 bf16 models)."""
    from bdm_db1_tpu_torch.models.transformer_xl import TransformerXL

    m32 = TransformerXL(dataclasses.replace(model.cfg, dtype="float32",
                                            param_dtype="float32"),
                        model.vocab, vision=model.vision, device="cuda")
    m32.load_state_dict(model.state_dict())
    return m32


@torch.no_grad()
def _spec_vs_classic(model, make_tenv, names, layout, forced: bool) -> dict:
    """SPEC_CHECK_B envs: one episode-start prime through the classic
    decoder into one cache, copied; then SPEC_CHECK_STEPS env steps through
    the speculative decoder (its first step takes the classic step's one
    deferred token and the whole block as its guesses, as an adaptive
    switch does) and the classic decoder, one copy each, the envs stepped
    by the classic actions. Later steps carry the speculative decoder's
    own block, or with ``forced`` the classic one. The share of equal
    action tokens (all dims, and dim 0 alone, which both take from the
    prime's last real row, and the later dims) over the steps and at
    each, and the rounds."""
    from bdm_db1_tpu_torch.eval.decode import build_decoder_for_env

    tenvs = [make_tenv(nm) for nm in names[:SPEC_CHECK_B]]
    spec = build_decoder_for_env(model, tenvs[0], pad_buckets="default")
    with _model_flags(model, decode_speculative=False):
        plain = build_decoder_for_env(model, tenvs[0], pad_buckets="default")
    if not spec.speculates or plain.speculates:
        raise AssertionError("decoder modes off")
    B = len(tenvs)
    sep = np.full((B, 1), layout.separator_id, np.int64)
    act, mems = plain.decode(_start_primes(tenvs, sep, 7),
                             plain.init_mems(B), defer_last=True)
    caches = {"spec": _copy_cache(mems), "plain": mems}
    carry = {"spec": act[:, -1:], "plain": act[:, -1:]}
    guess = act
    equal, equal0, later, rounds = [], [], [], []
    for _ in range(SPEC_CHECK_STEPS):
        obs = _step_obs(tenvs, act, sep)
        a_s, caches["spec"] = spec.decode(
            obs, caches["spec"], deferred_tok=carry["spec"],
            defer_last=True, guess_tok=guess)
        rounds.append(spec.last_spec_rounds)
        a_p, caches["plain"] = plain.decode(
            obs, caches["plain"], deferred_tok=carry["plain"],
            defer_last=True)
        guess = a_p if forced else a_s
        carry = {"spec": guess, "plain": a_p[:, -1:]}
        equal.append(float((a_s == a_p).mean()))
        equal0.append(float((a_s[:, 0] == a_p[:, 0]).mean()))
        later.append(float((a_s[:, 1:] == a_p[:, 1:]).mean()))
        act = a_p
    return {"batch": B, "env_steps": SPEC_CHECK_STEPS, "forced": forced,
            "equal_action_share": float(np.mean(equal)),
            "equal_first_dim_share": float(np.mean(equal0)),
            "equal_later_dims_share": float(np.mean(later)),
            "equal_action_share_by_step": equal,
            "equal_first_dim_share_by_step": equal0,
            "equal_later_dims_share_by_step": later,
            "verify_rounds": rounds}


def _spec_action_check(model, make_tenv, names, layout) -> dict:
    """:func:`_spec_vs_classic` teacher-forced on the served model through
    the kernel route and through the plain ring branch (K9 stays on int8
    weights: it has no plain route on the card), held to each other
    within SPEC_ROUTE_MARGIN; for bf16 weights also free-running on an f32
    copy of them through the plain routes, at least SPEC_ACTION_SHARE of
    the tokens equal."""
    def forced():
        return _spec_vs_classic(model, make_tenv, names, layout, True)

    keep = ("quant_matmul",) if model.decode_weights_quantized() else ()
    out = {"forced": {"kernel": forced(),
                      "plain": _plain_routes(model, forced, keep=keep)},
           "route_margin": SPEC_ROUTE_MARGIN, "share_min": SPEC_ACTION_SHARE}
    if not model.decode_weights_quantized():
        m32 = _f32_copy(model)
        out["f32"] = _spec_vs_classic(m32, make_tenv, names, layout, False)
        del m32
        torch.cuda.empty_cache()
    k, p = out["forced"]["kernel"], out["forced"]["plain"]
    if not (all(k[key] >= p[key] - SPEC_ROUTE_MARGIN for key in (
            "equal_first_dim_share", "equal_later_dims_share"))
            and out.get("f32", {}).get("equal_action_share", 1.0)
            >= SPEC_ACTION_SHARE):
        raise AssertionError(f"speculative against classic actions: {out}")
    return out


def _adaptive_steps(model, make_tenv, names, layout, n: int) -> dict:
    """An adaptive decoder (``decode_spec_adaptive``) and one
    ``AdaptiveSpecSession`` with the default controller: ``prewarm`` at the
    steady geometry (timed), the episode-start prime, then n steady env
    steps, each ended by its host read: the mode of each step, the
    controller's switches, rounds and average, the step times."""
    from bdm_db1_tpu_torch.eval.decode import (
        AdaptiveSpecSession, build_decoder_for_env,
    )

    tenvs = [make_tenv(nm) for nm in names]
    with _model_flags(model, decode_spec_adaptive=True):
        adec = build_decoder_for_env(model, tenvs[0], pad_buckets="default")
    sess = AdaptiveSpecSession(adec)
    B = len(tenvs)
    sep = np.full((B, 1), layout.separator_id, np.int64)
    start = _start_primes(tenvs, sep, 11)
    t0 = time.perf_counter()
    sess.prewarm(start[:, -adec.obs_length - 1:])
    torch.cuda.synchronize()
    prewarm_s = time.perf_counter() - t0
    act, mems = sess.decode(start, adec.init_mems(B), defer_last=True)
    modes, times = [], []
    for _ in range(n):
        obs = _step_obs(tenvs, act, sep)
        t0 = time.perf_counter()
        act, mems = sess.decode(obs, mems,
                                deferred_tok=act[:, -sess.defer_width:],
                                defer_last=True)
        times.append((time.perf_counter() - t0) * 1e3)
        modes.append("speculative" if sess.last_was_spec else "classic")
    ctl = sess.ctl
    return {"steps": n, "modes": modes, "switches": ctl.switches,
            "spec_steps": ctl.spec_steps, "total_steps": ctl.total_steps,
            "rounds_mean": ctl.rounds_sum / max(ctl.rounds_n, 1),
            "rounds_ewma": ctl.ewma, "exit_rounds": ctl.exit_rounds,
            "reenter_rounds": ctl.reenter_rounds, "step_ms": times,
            "prewarm_s": prewarm_s, "rk_widths": adec._rk.widths()}


def _spec_leg(batch: int, steps: int, full: bool, seed: int = 0,
              **overrides) -> dict:
    """db1_1p2b with ``decode_speculative`` serving ``batch`` lockstep
    HalfCheetah-geometry envs for ``steps`` env steps at the default
    buckets through ``evaluate_envs_lockstep`` (warmed once, then
    counted). Checks the launches against the speculative plan (the
    prime's ring calls with the guess tail on the last, then the recorded
    verify rounds at q = S; no q = 1 forward), the records and the action
    range; the layer-by-layer route check at the speculative shapes (a
    29-row prime with its guesses, a 5-row verify) and the action share
    against the classic decoder. With ``full``: the steady rate, idle
    share and rounds of both decoders timed in turns (SPEC_TURNS) and the
    adaptive session."""
    from bdm_db1_tpu_torch.eval.decode import DecoderPool
    from bdm_db1_tpu_torch.eval.harness import evaluate_envs_lockstep
    from bdm_db1_tpu_torch.ops import flash_ring_decode as fro

    cfg, model, layout, names, make_tenv = _serve_setup(
        batch, steps, seed, decode_speculative=True, **overrides)
    int8_cache = cfg.model.decode_cache_dtype == "int8"
    int8_weights = cfg.model.decode_weight_dtype == "int8"
    L, A = cfg.model.n_layer, 6
    run = dict(num_trials=1, seed=100, batch_size=batch, interleave=1,
               strict_length=True)
    pool = _RecordingPool(DecoderPool(model, pad_buckets="default"))
    evaluate_envs_lockstep(model, names, make_tenv, decoder_pool=pool,
                           max_step_size=2, **run)
    torch.cuda.synchronize()
    rec = pool.get(make_tenv(names[0]))
    rec.acts.clear()
    rec.rounds.clear()

    # ---- the main path, counted ------------------------------------------
    _reset_launches()
    t0 = time.perf_counter()
    res = evaluate_envs_lockstep(model, names, make_tenv, decoder_pool=pool,
                                 max_step_size=steps, **run)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_launches()
    # ----------------------------------------------------------------------

    dec = rec.inner
    rounds = list(rec.rounds)
    if not dec.speculates or dec.action_length - 1 != SPEC_S \
            or len(rounds) != steps:
        raise AssertionError(f"not a speculative decoder at S {SPEC_S}: "
                             f"rounds {rounds}")
    prompt, _ = make_tenv(names[0]).get_prompt(
        strict_length=True, rng=np.random.RandomState(0))
    first = _spec_widths(dec, len(prompt) + dec.obs_length + 1, 0)
    steady = _spec_widths(dec, dec.obs_length + 1 + A, A)
    if steady != [SPEC_PRIME_Q]:
        raise AssertionError(f"the steady speculative prime is {steady}, "
                             f"not one call of {SPEC_PRIME_Q} rows")
    calls = [first] + [steady] * (steps - 1)
    ring = [w for c in calls for w in c]
    suffix = "_int8" if int8_cache else ""
    want = dict.fromkeys(launches, 0)
    want["flash_ring_prime_ap" + suffix] = L * (
        sum(2 <= w <= fro.MAX_PRIME_Q for w in ring) + sum(rounds))
    want["flash_ring_decode" + suffix] = L * ring.count(1)
    if int8_weights:
        want["quant_matmul"] = 4 * L * (len(ring) + sum(rounds))
    if launches != want:
        raise AssertionError(f"kernel launches {launches}, expected {want}")
    if not all(r["length_mean"] == steps and r["num_trials"] == 1
               and np.isfinite(r["return_mean"]) for r in res):
        raise AssertionError(f"episode records off: {res[:3]}")
    acts = torch.cat(rec.acts).cpu().numpy()
    if acts.shape != (steps * batch, A) or not (
            (acts >= layout.continuous_offset)
            & (acts < layout.separator_id)).all():
        raise AssertionError(f"action tokens off: shape {acts.shape}, "
                             f"range {acts.min()}..{acts.max()}")
    routes = _route_check(model, layout, batch, make_tenv, names,
                          f32_copy=False, spec=SPEC_S)
    share = _spec_action_check(model, make_tenv, names, layout)
    out = {"config": "db1_1p2b", "dtype": "bfloat16",
           "decode_cache_dtype": cfg.model.decode_cache_dtype,
           "decode_weight_dtype": cfg.model.decode_weight_dtype,
           "batch": batch, "env_steps": steps, "first_prime_calls": first,
           "steady_prime_call": steady[0], "verify_rounds": rounds,
           "rounds_mean": float(np.mean(rounds)),
           "rounds_max": int(max(rounds)),
           "forwards": len(ring) + sum(rounds),
           "classic_forwards": len(first) + steps * (A - 1) + steps - 1,
           "launches": launches, "launches_expected": want,
           "wall_s": wall, "actions_per_sec": batch * steps / wall,
           "kernel_vs_plain": routes, "vs_classic": share}
    if full:
        classic = _RecordingPool(DecoderPool(model, pad_buckets="default"))
        with _model_flags(model, decode_speculative=False):
            classic.get(make_tenv(names[0]))
        _steady_steps(model, classic, make_tenv, names, layout, A, n=1)
        pools = {"speculative": pool, "classic": classic}
        turns = [(name, _steady_steps(model, pools[name], make_tenv, names,
                                      layout, A, n=SPEC_TURN_STEPS))
                 for name in SPEC_TURNS]
        out.update({k: v for k, v in turns[0][1].items()})
        out["spec_ab"] = {
            name: {key: [t.get(key) for n, t in turns if n == name]
                   for key in ("steady_actions_per_sec",
                               "steady_step_ms_median", "device_busy_ms",
                               "device_idle_share", "verify_rounds")}
            for name in pools}
        out["adaptive"] = _adaptive_steps(model, make_tenv, names, layout,
                                          SPEC_ADAPTIVE_STEPS)
    return out


def phase_serve_spec(smi: str, seed: int = 0) -> dict:
    """Speculative serving: the bf16 leg (the ``serve`` configuration, 40
    envs, SPEC_STEPS steps, full readings) and the int8 leg (int8 cache and
    weights, 56 envs, SPEC_INT8_STEPS steps). ``launches`` sums both
    legs."""
    bf16 = _spec_leg(40, SPEC_STEPS, True, seed)
    gc.collect()
    torch.cuda.empty_cache()
    int8 = _spec_leg(56, SPEC_INT8_STEPS, False, seed,
                     decode_cache_dtype="int8", decode_weight_dtype="int8")
    launches = {k: bf16["launches"][k] + int8["launches"][k]
                for k in bf16["launches"]}
    return {"phase": "serve_spec", "card": smi, "launches": launches,
            "bf16": bf16, "int8": int8}


TEXT_ENV = "fake-text-v0"
TEXT_TRIALS = 40
TEXT_STEPS = 8


def phase_evaluate_rl_text(smi: str, vis_dir: str, saved_weights: dict,
                           seed: int = 0) -> dict:
    """Needs ``pretrain_vision``: ``evaluate_rl.main`` serves its
    checkpoint in bf16 on ``fake-text-v0`` (a mission of 18 byte tokens
    and a 32 x 32 frame, 4 patch slots, an observation; one discrete
    action token), TEXT_TRIALS episodes of TEXT_STEPS steps in one
    lockstep cohort with an expert prompt whose first prime
    ``_image_chunk_plan`` cuts; the env's trajectory cache is written from
    the live env first. Before the counted run: the weights read
    (``load_params`` takes the port checkpoint, every weight the saved one
    cast to bf16) and the route check at B 40 on the text prime. Checks
    the records, ``results.output`` and the K1/K2 launches of the slice
    plan (the steady [action || mission || patches || sep] prime, 24
    tokens, one K2 call; no q = 1 forward, so K1 0)."""
    from bdm_db1_tpu_torch.core.config import db1_1p2b
    from bdm_db1_tpu_torch.data.rl_dataset import (
        TrajectoryStore, build_rl_dataset_from_cache,
    )
    from bdm_db1_tpu_torch.eval import evaluate_rl
    from bdm_db1_tpu_torch.eval.decode import build_decoder_for_env
    from bdm_db1_tpu_torch.eval.envs import make_env
    from bdm_db1_tpu_torch.eval.wrapper import TokenizedEnv
    from bdm_db1_tpu_torch.models.transformer_xl import TransformerXL
    from bdm_db1_tpu_torch.ops import flash_ring_decode as fro
    from bdm_db1_tpu_torch.train import pretrain

    cache_dir = os.path.join(vis_dir, "rl_text")
    out_dir = os.path.join(vis_dir, "out_text")
    TrajectoryStore.from_env_name(TEXT_ENV, cache_dir)
    cfg = db1_1p2b()
    cfg.model.param_dtype = "bfloat16"
    cfg.data.rl_dataset_cache_dir = cache_dir
    cfg.train.load_dir = os.path.join(vis_dir, "run")
    cfg.train.save_dir = out_dir
    cfg.eval = dataclasses.replace(
        cfg.eval, env_names=(TEXT_ENV,), num_trials=TEXT_TRIALS,
        batched=True, batch_size=TEXT_TRIALS, max_step_size=TEXT_STEPS)

    model = TransformerXL(cfg.model, cfg.vocab, vision=cfg.vision,
                          device="cuda")
    if evaluate_rl.load_params(cfg, model) != evaluate_rl.FROM_PORT:
        raise AssertionError("load_params did not read the port checkpoint")
    sd = model.state_dict()
    bad = [n for n, t in saved_weights.items()
           if not torch.equal(sd[n].cpu(), t.to(sd[n].dtype))]
    if bad or sd.keys() != saved_weights.keys():
        raise AssertionError(f"loaded weights differ from the saved ones: "
                             f"{bad[:5]}")
    del sd
    tok = pretrain.build_tokenizer_suite(cfg)

    def make_tenv(name):
        return TokenizedEnv(make_env(name), build_rl_dataset_from_cache(
            name, cache_dir, cfg.model.n_position, tok))

    tenv = make_tenv(TEXT_ENV)
    if tenv.ds.obs_type_spec.get("mission") != "text":
        raise AssertionError(f"no text leaf: {tenv.ds.obs_type_spec}")
    dec = build_decoder_for_env(model, tenv, pad_buckets="default")
    prompt, prompt_img = tenv.get_prompt(strict_length=True,
                                         rng=np.random.RandomState(0))
    q0 = len(prompt) + dec.obs_length + 1
    n0 = len(prompt_img) + 1
    slices = dec.prime_plan(q0, 0, n0)[0]
    steady = dec.prime_plan(dec.obs_length + 2, 1, 1)[0]
    if len(slices) < 2 or len(steady) != 1 \
            or steady[0] > fro.MAX_PRIME_Q:
        raise AssertionError(f"prime plan off: first {slices}, steady "
                             f"{steady}")
    A = dec.action_length
    routes = _route_check(model, cfg.vocab.layout(), TEXT_TRIALS,
                          make_tenv, [TEXT_ENV] * TEXT_TRIALS,
                          f32_copy=False)
    del model, dec
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the main path, counted ------------------------------------------
    _reset_launches()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        res = evaluate_rl.main(cfg, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_launches()
    # ----------------------------------------------------------------------
    sys.stdout.write(out.getvalue())

    L, steps = cfg.model.n_layer, TEXT_STEPS
    want = dict.fromkeys(launches, 0)
    want["flash_ring_decode"] = L * (steps * (A - 1) + slices.count(1))
    want["flash_ring_prime_ap"] = L * (
        steps - 1 + sum(2 <= q <= fro.MAX_PRIME_Q for q in slices))
    if launches != want:
        raise AssertionError(f"kernel launches {launches}, expected {want}")
    if "restored port checkpoint" not in out.getvalue():
        raise AssertionError("main did not read the port checkpoint")
    if not (len(res) == 1 and res[0]["env"] == TEXT_ENV
            and res[0]["num_trials"] == TEXT_TRIALS
            and res[0]["length_mean"] == steps
            and np.isfinite(res[0]["return_mean"])):
        raise AssertionError(f"records off: {res}")
    with open(os.path.join(out_dir, "results.output")) as f:
        if f.read().splitlines() != [json.dumps(r) for r in res]:
            raise AssertionError("results.output off")
    return {"phase": "evaluate_rl_text", "config": "db1_1p2b",
            "dtype": "bfloat16", "param_dtype": "bfloat16", "card": smi,
            "env": TEXT_ENV, "obs_tokens": tenv.obs_length,
            "obs_types": tenv.ds.obs_type_spec, "action_tokens": A,
            "trials": TEXT_TRIALS, "env_steps": steps,
            "first_prime": {"q": q0, "frames": n0}, "prime_slices": slices,
            "steady_prime": steady[0],
            "launches": launches, "launches_expected": want,
            "kernel_vs_plain": routes, "records": res, "wall_s": wall,
            "actions_per_sec": TEXT_TRIALS * steps / wall}


STATELESS_B = 8
STATELESS_STEPS = 8


class _WindowRecorder:
    """Keeps each sequence a window decoder is given, its actions and the
    call's wall time (the decoder returns host arrays, so each call ends
    in a host read)."""

    def __init__(self, inner):
        self.inner = inner
        self.seqs, self.acts, self.ms = [], [], []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def decode(self, seq, env_action_mask=None):
        t0 = time.perf_counter()
        act, ext = self.inner.decode(seq, env_action_mask)
        self.ms.append((time.perf_counter() - t0) * 1e3)
        self.seqs.append(np.array(seq))
        self.acts.append(act)
        return act, ext


class _WindowModel:
    """The model as a ``WindowDecoder`` sees it, keeping the logits of
    each of its forwards ([B, V], one an action dim); with
    ``zero_memory`` every trunk forward also attends the ring's mem_len
    zero rows (a zero cache's hidden states), as a ring decode from an
    empty cache does."""

    def __init__(self, model, zero_memory: bool = False):
        self.model = model
        self.zero_memory = zero_memory
        self.logged = []

    def __getattr__(self, name):
        return getattr(self.model, name)

    def trunk(self, h, mems):
        if self.zero_memory:
            mems = self.model.init_mems(h.shape[0])
        return self.model.trunk(h, mems)

    def logits(self, h):
        out = self.model.logits(h)
        self.logged.append(out)
        return out


def _rel_diff(a, b) -> float:
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


@torch.no_grad()
def phase_stateless(smi: str, seed: int = 0) -> dict:
    """The stateless (mem-less) evaluation at db1_1p2b in bf16 (random
    weights from ``seed``) on the HalfCheetah geometry: ``WindowDecoder``
    over a 1024-token window, one trunk forward (K3, 24 launches) an
    action dim. Counted: ``run_episode_stateless`` at B 1, one episode of
    STATELESS_STEPS steps with a fixed expert prompt, then
    ``decode_batch`` over STATELESS_B rows of different lengths (the
    episode's sequences). Checks the K3 launches, ``decode_batch`` against
    the single decodes and, layer by layer, K3 against ``rel_attention``
    on the longest window; then ``decode_batch`` on the K3 route against
    the same decoder on the rel_attention route (:func:`_window_routes`)
    and, on an f32 copy of the weights, against the ring decode
    (:func:`_window_vs_ring`). Reads actions/sec and the step time."""
    from bdm_db1_tpu_torch.eval.decode import WindowDecoder
    from bdm_db1_tpu_torch.eval.harness import run_episode_stateless

    cfg, model, layout, names, make_tenv = _serve_setup(
        STATELESS_B, STATELESS_STEPS, seed)
    tenv = make_tenv(names[0])
    A, obs_len = tenv.action_length, tenv.obs_length
    wdec = _WindowRecorder(WindowDecoder(model, layout, obs_len, A, False))
    W = wdec.window
    sep = tenv.separator_id
    wdec.inner.decode(np.concatenate([tenv.reset()[0], [sep]]))  # warm-up
    torch.cuda.synchronize()

    # ---- the main path, counted ------------------------------------------
    _reset_launches()
    t0 = time.perf_counter()
    ep = run_episode_stateless(tenv, wdec, use_prompt=True,
                               prompt_strategy="fixed_prompt",
                               rng=np.random.RandomState(seed))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = wdec.seqs[-STATELESS_B:]
    t0 = time.perf_counter()
    acts_b, _ = wdec.inner.decode_batch(rows)
    torch.cuda.synchronize()
    wall_b = time.perf_counter() - t0
    launches = _read_launches()
    # ----------------------------------------------------------------------

    L = cfg.model.n_layer
    want = dict.fromkeys(launches, 0)
    want["flash_rel_attention"] = L * A * (STATELESS_STEPS + 1)
    if launches != want:
        raise AssertionError(f"kernel launches {launches}, expected {want}")
    if ep.episode_length != STATELESS_STEPS or not np.isfinite(
            ep.episode_return) or len(rows) != STATELESS_B:
        raise AssertionError(f"episode off: {ep}, {len(rows)} rows")
    for i, row in enumerate(rows):
        if not np.array_equal(acts_b[i], wdec.acts[-STATELESS_B + i]):
            raise AssertionError(f"decode_batch row {i} differs from its "
                                 f"single decode")

    routes = _window_route_check(model, wdec.seqs[-1], obs_len, A)
    m32 = _f32_copy(model)
    windows = _window_routes(model, m32, rows, tenv)
    vs_ring = _window_vs_ring(m32, rows, tenv)
    del m32
    torch.cuda.empty_cache()
    rec = {"phase": "stateless", "config": "db1_1p2b", "dtype": "bfloat16",
           "param_dtype": "bfloat16", "card": smi, "window": W,
           "obs_tokens": obs_len, "action_tokens": A,
           "episode": {"steps": ep.episode_length,
                       "return": ep.episode_return,
                       "seq_lengths": [len(s) for s in wdec.seqs]},
           "batch": STATELESS_B, "launches": launches,
           "launches_expected": want, "wall_s": wall,
           "actions_per_sec": STATELESS_STEPS / wall,
           "step_ms": wdec.ms, "step_ms_median": float(np.median(wdec.ms)),
           "batch_wall_s": wall_b,
           "batch_actions_per_sec": STATELESS_B / wall_b,
           "kernel_vs_plain": routes, "k3_vs_rel_attention": windows,
           "vs_ring": vs_ring}
    if not (windows["first_action_logits_rel_diff"]
            <= windows["bf16_vs_f32_logits_rel_diff"]
            and vs_ring["first_action_logits_rel_diff"] <= LOGIT_REL_TOL
            and vs_ring["equal_action_share"] >= SPEC_ACTION_SHARE):
        raise AssertionError(f"window decode checks: {windows}, {vs_ring}")
    return rec


@torch.no_grad()
def _window_routes(model, m32, seqs, tenv) -> dict:
    """``WindowDecoder.decode_batch`` over ``seqs`` through the K3 route
    against the same decoder on the rel_attention route (``attention_impl``
    "xla"), same bf16 weights: the first forward's logits at each row's
    live position, max |diff| / max |logit|, at most as far apart as the
    rel_attention route's are from the same decoder's on ``m32``, the f32
    copy of the weights. The routes differ by a few of the roundings that
    bf16 itself makes (p cast per key tile against the full softmax), and
    24 layers grow either (on an H100 the routes read 0.063, past the one
    layer's LOGIT_REL_TOL); a wrong mask, scale or rotation moves the
    logits by O(1) of their size. The share of equal action tokens is
    read (a differing token changes the next dims' windows)."""
    from bdm_db1_tpu_torch.eval.decode import WindowDecoder

    A, obs_len = tenv.action_length, tenv.obs_length
    runs = {}
    for route, m in (("kernel", model), ("plain", model), ("f32", m32)):
        wm = _WindowModel(m)
        dec = WindowDecoder(wm, tenv.tok.layout, obs_len, A, False)
        acts = (_plain_routes(model, lambda: dec.decode_batch(seqs)[0])
                if route == "plain" else dec.decode_batch(seqs)[0])
        runs[route] = (acts, wm.logged[0])
    (a_k, l_k), (a_p, l_p), (_, l_32) = (runs[r] for r in runs)
    return {"batch": len(seqs),
            "first_action_logits_rel_diff": _rel_diff(l_k, l_p),
            "bf16_vs_f32_logits_rel_diff": _rel_diff(l_p, l_32),
            "equal_action_share": float((a_k == a_p).mean())}


@torch.no_grad()
def _window_vs_ring(model, seqs, tenv) -> dict:
    """``WindowDecoder.decode_batch`` over ``seqs`` against the ring decode
    of each (B 1, from an empty cache), on an f32 copy of the weights (the
    plain routes): the first-action logits on the longest within
    LOGIT_REL_TOL and at least SPEC_ACTION_SHARE of the action tokens
    equal. The ring decode's queries attend its mem_len zero rows (the
    reference's zero memory: zero hidden states give zero K/V, the QKV
    projection has no bias) beside the sequence, and the window has no
    memory, so the window decoder's trunk is given the same zero rows
    (:class:`_WindowModel`): both then attend the same keys and differ
    only by rounding. Without them they differ by the zero rows' weight
    too (a window longer than n_layer x mem_len tokens would put them out
    of reach, the CPU test's case; 1024 is not)."""
    from bdm_db1_tpu_torch.eval.decode import (
        WindowDecoder, build_decoder_for_env,
    )

    layout = tenv.tok.layout
    A, obs_len = tenv.action_length, tenv.obs_length
    wm = _WindowModel(model, zero_memory=True)
    acts = WindowDecoder(wm, layout, obs_len, A, False).decode_batch(seqs)[0]
    ring = build_decoder_for_env(model, tenv)
    i = int(np.argmax([len(s) for s in seqs]))
    calls, got = [], []
    real_logits = model.logits
    model.logits = lambda h: calls.append(real_logits(h)) or calls[-1]
    try:
        for j, seq in enumerate(seqs):
            calls.clear()
            got.append(ring.decode(seq, ring.init_mems(1))[0])
            if j == i:          # one logits read a ring call: the prime's last
                first = calls[len(ring.prime_plan(len(seq), 0)[0]) - 1]
    finally:
        del model.logits
    return {"dtype": "float32", "seq_len": len(seqs[i]),
            "first_action_logits_rel_diff": _rel_diff(wm.logged[0][i:i + 1],
                                                      first),
            "equal_action_share": float((np.stack(got) == acts).mean())}


@torch.no_grad()
def _window_route_check(model, seq, obs_len: int, A: int) -> dict:
    """The window forward of ``seq`` at B 1 driven layer by layer: each
    layer's attention output through K3 against ``rel_attention`` on the
    same input, within ATTN_REL_TOL of its largest value."""
    from bdm_db1_tpu_torch.data.packing import action_flags_and_position_ids
    from bdm_db1_tpu_torch.models.transformer_xl import use_rel_kernel
    from bdm_db1_tpu_torch.ops.attention import same_length_mask
    from bdm_db1_tpu_torch.ops.positional import relative_positional_embedding

    cfg = model.cfg
    W = cfg.n_position
    if not use_rel_kernel(cfg, W, W, "cuda"):
        raise AssertionError("the window forward does not take K3")
    _, pos = action_flags_and_position_ids(W, obs_len, A, 0)
    tok = torch.zeros((1, W), dtype=torch.int64, device="cuda")
    tok[0, :len(seq)] = torch.as_tensor(seq, device="cuda")
    mask = same_length_mask(W, W, cfg.mem_len, device="cuda")
    r = relative_positional_embedding(W, cfg.n_embed,
                                      cfg.effective_clamp_len, device="cuda")
    h = model.embed_rl(tok, torch.as_tensor(pos, device="cuda")[None])
    errs = []
    for layer in model.h:
        attn = layer.dec_attn.attend(h, r, None, mask, True)
        attn_p = layer.dec_attn.attend(h, r, None, mask, False)
        errs.append(float((attn.float() - attn_p.float()).abs().max()
                          / attn_p.float().abs().max()))
        h = layer(h, None, r, mask, True)
    out = {"attn_tol": ATTN_REL_TOL, "attn_rel_err_max": max(errs),
           "attn_rel_err": errs}
    if not max(errs) <= ATTN_REL_TOL:
        raise AssertionError(f"K3 route vs rel_attention: {out}")
    return out


# ---- remat and the pre-LN hidden-state serve ---------------------------

REMAT_POLICIES = (None, "full", "dots", "dots_narrow")
REMAT_REPEATS = 3
# K3 forwards a layer and a micro-batch by policy (None: no remat): "full"
# runs each layer's forward again in the backward pass, the "dots"
# policies keep K3's outputs
REMAT_K3 = {None: 1, "full": 2, "dots": 1, "dots_narrow": 1}


class _KeepGrads:
    """The train step's optimizer in the remat phase: its step keeps the
    averaged gradients (the parameters' ``grad``, f32 on the card) and
    leaves the weights as they are, so every policy steps from the same
    weights."""

    def __init__(self, params):
        self.params = params
        self.grads = None

    def step(self):
        self.grads = [None if p.grad is None else p.grad
                      for p in self.params]

    def zero_grad(self, set_to_none=True):
        for p in self.params:
            p.grad = None


def _grad_agreement(got, ref) -> dict:
    """Cosine and relative norm difference of two gradient lists (``ref``
    on the host, ``got`` on the card), over the entries both have."""
    dot = ng = nr = 0.0
    for x, y in zip(got, ref):
        if x is None or y is None:
            continue
        x, y = x.double(), y.to(x.device).double()
        dot += float((x * y).sum())
        ng += float(x.square().sum())
        nr += float(y.square().sum())
    ng, nr = ng ** 0.5, nr ** 0.5
    return {"grad_cosine": dot / (ng * nr),
            "grad_norm_rel_diff": abs(ng - nr) / nr}


def _remat_want(policy, launches: dict, L: int, accum: int) -> dict:
    want = dict.fromkeys(launches, 0)
    want["flash_rel_attention"] = REMAT_K3[policy] * L * accum
    want["flash_rel_attention_bwd_dq"] = L * accum
    want["flash_rel_attention_bwd_dkv"] = L * accum
    return want


def phase_remat(smi: str, seed: int = 0) -> dict:
    """Rematerialization at the train phase's shape: db1_1p2b (bf16
    activations, f32 parameters, the ModelConfig dropout rates), one loader
    batch of 2 micro-batches x 4 x 1024 tokens through ``make_train_step``
    with an optimizer that keeps the gradients and leaves the weights (so
    every run starts from the same weights), the same generator seed each
    run. Remat off, then ``remat_policy`` "full", "dots" and "dots_narrow"
    (REMAT_REPEATS steps each, the first counted): the loss bitwise the
    no-remat loss (the forward is deterministic), the generator state after
    the step equal, the gradients' cosine and norm within the train
    phase's route limits (K5's f32 atomics make the backward vary from run
    to run); K3 launches 48 a micro-batch under "full", 24 under the
    others, K4 and K5 24. Reads each policy's peak memory, median step and,
    from one more step profiled, its device busy time and idle share.
    Then one step of the same model as pre-LN (``pre_lnorm``, remat
    "dots_narrow"): a finite loss and K3, K4 and K5 launched."""
    from bdm_db1_tpu_torch.train.step import TrainState, make_train_step
    from bdm_db1_tpu_torch.train.trainer import to_gato_batch

    cfg, model, full, loader = _train_setup(seed)
    try:
        batch = to_gato_batch(next(loader), "cuda")
    finally:
        loader.stop()
    L = cfg.model.n_layer
    accum = TRAIN_ACCUM
    keep = _KeepGrads([p for p in model.parameters() if p.requires_grad])
    step = make_train_step(model)

    def run(policy, pre_ln=False):
        model.cfg.remat = policy is not None
        model.cfg.remat_policy = policy or "full"
        model.cfg.pre_lnorm = pre_ln
        gen = torch.Generator(device="cuda").manual_seed(seed + 11)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, met = step(TrainState(step=0, model=model, optimizer=keep), batch,
                      gen)
        loss = float(met["loss"])
        return loss, (time.perf_counter() - t0) * 1e3, gen.get_state()

    flags = (cfg.model.remat, cfg.model.remat_policy, cfg.model.pre_lnorm)
    rows, launches, ref = {}, dict.fromkeys(_read_launches(), 0), None
    try:
        run(None)                                      # warm-up
        for policy in REMAT_POLICIES:
            keep.grads = None
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            # ---- the main path, counted (the first step of each) ------
            _reset_launches()
            loss, ms, gen_state = run(policy)
            counted = _read_launches()
            # -----------------------------------------------------------
            peak = torch.cuda.max_memory_allocated()
            times = [ms] + [run(policy)[1] for _ in range(REMAT_REPEATS - 1)]
            busy, top, _, host = _profile_busy(lambda: run(policy),
                                               keep=("k3_",))
            for k, v in counted.items():
                launches[k] += v
            want = _remat_want(policy, counted, L, accum)
            med = float(np.median(times))
            row = {"loss": loss, "launches": counted,
                   "launches_expected": want,
                   "max_memory_allocated_gb": peak / 1e9,
                   "step_ms": times, "step_ms_median": med,
                   "device_busy_ms": busy * 1e3,
                   "device_idle_share": 1.0 - busy * 1e3 / med,
                   "top_device_ms": top, "host_top_ms": host}
            if policy is None:
                ref = (loss, gen_state, [None if g is None else g.cpu()
                                         for g in keep.grads])
            else:
                row.update(_grad_agreement(keep.grads, ref[2]),
                           loss_bitwise=loss == ref[0],
                           generator_equal=bool(torch.equal(gen_state,
                                                            ref[1])))
                if not (row["loss_bitwise"] and row["generator_equal"]
                        and row["grad_cosine"] >= GRAD_COS_MIN
                        and row["grad_norm_rel_diff"] <= GRAD_NORM_RTOL):
                    raise AssertionError(f"remat {policy} against no remat: "
                                         f"{row}")
            if counted != want:
                raise AssertionError(f"remat {policy}: kernel launches "
                                     f"{counted}, expected {want}")
            rows[policy or "off"] = row
        ref = keep.grads = None
        gc.collect()
        torch.cuda.empty_cache()
        # ---- pre-LN under "dots_narrow", counted -----------------------
        _reset_launches()
        loss, ms, _ = run("dots_narrow", pre_ln=True)
        counted = _read_launches()
        # ----------------------------------------------------------------
        for k, v in counted.items():
            launches[k] += v
        pre = {"loss": loss, "step_ms": ms, "launches": counted,
               "launches_expected": _remat_want("dots_narrow", counted, L,
                                                accum)}
        if not (np.isfinite(loss) and counted == pre["launches_expected"]):
            raise AssertionError(f"pre-LN step: {pre}")
    finally:
        (model.cfg.remat, model.cfg.remat_policy,
         model.cfg.pre_lnorm) = flags
        keep.grads = None
    return {"phase": "remat", "config": "db1_1p2b", "dtype": "bfloat16",
            "param_dtype": "float32", "micro_batch": TRAIN_MICRO,
            "accum": accum, "seq_length": cfg.data.seq_length, "card": smi,
            "step": "make_train_step with an optimizer that keeps the "
                    "gradients (no weight update)",
            "grad_cosine_min": GRAD_COS_MIN,
            "grad_norm_rtol": GRAD_NORM_RTOL, "policies": rows,
            "pre_ln_dots_narrow": pre, "launches": launches}


PRELN_ENV = "halfcheetah-geometry-preln-v0"
PRELN_TRIALS = 40
PRELN_STEPS = 8
PRELN_CHECK_B = 8


@torch.no_grad()
def _hidden_vs_ring(model, prime, obs_len: int, A: int, layout) -> dict:
    """One prime [B, q] and its A - 1 action feeds over a post-LN model:
    through the ring decode (an ActionDecoder over the zero ring cache,
    its own greedy actions) and, fed the same actions, through
    ``decode_rl`` over zero hidden memory (the hidden-state decode). The
    two attend the same keys (zero hidden states give zero K/V) and differ
    only by rounding: each forward's logits (the prime's last ring slice,
    then each feed) max |diff| / max |ring logit|, and the share of the
    hidden path's greedy actions equal to the ring's."""
    from bdm_db1_tpu_torch.data.packing import action_flags_and_position_ids
    from bdm_db1_tpu_torch.eval.decode import ActionDecoder

    B, q = prime.shape
    dec = ActionDecoder(model, layout, obs_len, A, False)
    if not dec.use_kv_cache:
        raise AssertionError("the post-LN decoder does not take the ring")
    calls = []
    real_logits = model.logits
    model.logits = lambda h: calls.append(real_logits(h)) or calls[-1]
    try:
        act, _ = dec.decode(prime, dec.init_mems(B))
    finally:
        del model.logits
    n = len(dec.prime_plan(q, 0)[0])
    ring = [calls[n - 1]] + calls[n:n + A - 1]
    dev = model.device
    _, pos = action_flags_and_position_ids(q, obs_len, A, 0)
    pos = torch.as_tensor(np.broadcast_to(pos, (B, q)).copy(), device=dev)
    lg, mems = model.decode_rl(torch.as_tensor(prime, device=dev), pos,
                               model.init_mems(B))
    hidden = [lg]
    fed = torch.as_tensor(act, device=dev)
    zero = torch.zeros((B, 1), dtype=torch.int64, device=dev)
    for j in range(A - 1):
        lg, mems = model.decode_rl(fed[:, j:j + 1], zero, mems)
        hidden.append(lg)
    bias = torch.as_tensor(layout.continuous_action_logit_bias(), device=dev)
    h_act = torch.stack([torch.argmax(x + bias, -1) for x in hidden], 1)
    return {"dtype": str(model.dtype).replace("torch.", ""),
            "prime_q": q, "ring_prime_slices": n,
            "logits_rel_diff": [_rel_diff(h, r) for h, r in
                                zip(hidden, ring)],
            "equal_action_share": float((h_act.cpu().numpy() == act).mean()),
            "ring_first": ring[0]}


@torch.no_grad()
def _hidden_ring_layers(model, prime, obs_len: int, A: int, layout) -> dict:
    """The hidden-state route against the ring route layer by layer, from
    one state: ``decode_rl`` primes zero hidden memory with ``prime``; the
    ring cache (cursor 0) is each layer's K/V projection of that memory
    (a post-LN model's K/V are per-position projections of its hidden
    states). Then one single-token forward both ways, each layer from the
    same input: the trunk's layer over [memory || x] (``rel_attention`` at
    q == 1) against ``forward_ring`` (K1 in bf16), the outputs within
    ATTN_REL_TOL of their largest value, and the last layer's logits
    within LOGIT_REL_TOL."""
    from bdm_db1_tpu_torch.data.packing import action_flags_and_position_ids
    from bdm_db1_tpu_torch.models.transformer_xl import use_rel_kernel
    from bdm_db1_tpu_torch.ops.attention import same_length_mask
    from bdm_db1_tpu_torch.ops.positional import relative_positional_embedding

    cfg = model.cfg
    dev, dt = model.device, model.dtype
    B, q = prime.shape
    M, D, H, Dh = cfg.mem_len, cfg.n_embed, cfg.n_head, cfg.d_head
    _, pos = action_flags_and_position_ids(q, obs_len, A, 0)
    pos = torch.as_tensor(np.broadcast_to(pos, (B, q)).copy(), device=dev)
    _, mems = model.decode_rl(torch.as_tensor(prime, device=dev), pos,
                              model.init_mems(B))
    k, v = [], []
    for li, layer in enumerate(model.h):
        _, kl, vl = F.linear(mems[li].to(dt), layer.dec_attn.qkv_net.weight
                             .to(dt)).split(D, dim=-1)
        k.append(kl.unflatten(-1, (H, Dh)))
        v.append(vl.unflatten(-1, (H, Dh)))
    cache = {"k": torch.stack(k), "v": torch.stack(v), "cursor": 0}
    del k, v
    tok = torch.full((B, 1), layout.continuous_offset + 3, device=dev)
    h = model.embed_rl(tok, torch.zeros_like(tok))
    mask = same_length_mask(1, M + 1, M, device=dev)
    r = relative_positional_embedding(M + 1, D, cfg.effective_clamp_len,
                                      device=dev)
    use_kernel = use_rel_kernel(cfg, 1, M + 1, dev)
    ring_mask, mask_s = model.ring_masks(1, 0, dev)
    rk = model.precompute_rk(1)
    kernels = model.use_kernels(1, cache)
    errs = []
    for li, layer in enumerate(model.h):
        h_in = h
        h = layer(h_in, mems[li], r, mask, use_kernel)
        h_ring = layer.forward_ring(h_in, rk[li], cache, li, ring_mask,
                                    mask_s, kernels)[0]
        errs.append(_rel_diff(h, h_ring))
    out = {"attn_tol": ATTN_REL_TOL, "logit_tol": LOGIT_REL_TOL,
           "ring_kernels": kernels, "layer_out_rel_err_max": max(errs),
           "layer_out_rel_err": errs,
           "last_layer_logits_rel_err": _rel_diff(
               model.logits(h[:, -1]), model.logits(h_ring[:, -1]))}
    if not (max(errs) <= ATTN_REL_TOL
            and out["last_layer_logits_rel_err"] <= LOGIT_REL_TOL):
        raise AssertionError(f"hidden-state route against the ring route, "
                             f"layer by layer: {out}")
    return out


def _hidden_ring_check(seed: int) -> dict:
    """The hidden-state decode against the ring decode on a post-LN
    db1_1p2b, PRELN_CHECK_B envs with their episode-start primes: in bf16
    layer by layer from one state (:func:`_hidden_ring_layers`, gated)
    and end to end (:func:`_hidden_vs_ring`: the logits of both, read as
    they drift apart over 24 layers in bf16, as the ring's bf16 logits
    drift from its f32 ones, and the share of equal greedy actions); on an
    f32 copy end to end, gated: the logits within LOGIT_REL_TOL and at
    least SPEC_ACTION_SHARE of the actions equal."""
    cfg, model, layout, names, make_tenv = _serve_setup(
        PRELN_CHECK_B, PRELN_STEPS, seed)
    tenvs = [make_tenv(n) for n in names]
    sep = np.full((len(tenvs), 1), layout.separator_id, np.int64)
    prime = _start_primes(tenvs, sep, seed)
    obs_len, A = tenvs[0].obs_length, tenvs[0].action_length
    layers = _hidden_ring_layers(model, prime, obs_len, A, layout)
    bf = _hidden_vs_ring(model, prime, obs_len, A, layout)
    m32 = _f32_copy(model)
    f32 = _hidden_vs_ring(m32, prime, obs_len, A, layout)
    del m32, model
    gc.collect()
    torch.cuda.empty_cache()
    ring_bf16_vs_f32 = _rel_diff(bf.pop("ring_first"), f32.pop("ring_first"))
    out = {"batch": PRELN_CHECK_B, "bf16_layers": layers, "bf16": bf,
           "f32": f32, "ring_first_logits_bf16_vs_f32": ring_bf16_vs_f32,
           "logit_tol": LOGIT_REL_TOL, "action_share_min": SPEC_ACTION_SHARE}
    if not (max(f32["logits_rel_diff"]) <= LOGIT_REL_TOL
            and f32["equal_action_share"] >= SPEC_ACTION_SHARE):
        raise AssertionError(f"hidden-state decode against the ring: {out}")
    return out


@torch.no_grad()
def phase_serve_preln(smi: str, seed: int = 0) -> dict:
    """The hidden-state decode. First :func:`_hidden_ring_check` (a post-LN
    model both ways). Then a pre-LN db1_1p2b (``pre_lnorm``, bf16 weights
    and activations, random init from ``eval.seed``) served by
    ``evaluate_rl.main``: one registered HalfCheetah-geometry env with its
    cache, PRELN_TRIALS trials in one lockstep cohort, PRELN_STEPS steps,
    the expert prompt. Counted: K3 once a layer for the episode-start
    prime (q >= 64 over 1024 memory rows: the kernel gate admits it), no
    other kernel (the steady 18-token primes and the single-token feeds
    take rel_attention, and the ring kernels never run). Then one steady
    step of the cohort profiled (device busy, idle share) and timed, and
    K3 at the prompt's shape (B PRELN_TRIALS) against its plain version,
    timed with its bound and SDPA's time."""
    from bdm_db1_tpu_torch.core.config import db1_1p2b
    from bdm_db1_tpu_torch.data.rl_dataset import (
        TrajectoryStore, build_rl_dataset_from_cache,
    )
    from bdm_db1_tpu_torch.eval import evaluate_rl
    from bdm_db1_tpu_torch.eval.decode import build_decoder_for_env
    from bdm_db1_tpu_torch.eval.envs import FakeContinuousEnv, register_env
    from bdm_db1_tpu_torch.eval.wrapper import TokenizedEnv
    from bdm_db1_tpu_torch.models.transformer_xl import (
        TransformerXL, use_rel_kernel,
    )
    from bdm_db1_tpu_torch.ops import flash_rel_attention as fra
    from bdm_db1_tpu_torch.train import pretrain

    check = _hidden_ring_check(seed)
    work = tempfile.mkdtemp(prefix="chip_smoke_preln_")
    try:
        cache_dir, out_dir = (os.path.join(work, d) for d in ("rl", "out"))

        def env_fn(s=seed + 30):
            return FakeContinuousEnv(obs_dim=17, act_dim=6, seed=s)

        register_env(PRELN_ENV, env_fn)
        TrajectoryStore.from_flat_dataset(
            env_fn().make_dataset(10)).save_cache(cache_dir, PRELN_ENV)
        cfg = db1_1p2b(pre_lnorm=True)
        cfg.model.param_dtype = "bfloat16"
        cfg.data.rl_dataset_cache_dir = cache_dir
        cfg.train.load_dir, cfg.train.save_dir = "", out_dir
        cfg.eval = dataclasses.replace(
            cfg.eval, env_names=(PRELN_ENV,), num_trials=PRELN_TRIALS,
            batched=True, batch_size=PRELN_TRIALS, max_step_size=PRELN_STEPS)
        ds = build_rl_dataset_from_cache(
            PRELN_ENV, cache_dir, cfg.model.n_position,
            pretrain.build_tokenizer_suite(cfg))
        tenv = TokenizedEnv(env_fn(), ds)
        prompt, _ = tenv.get_prompt(strict_length=True,
                                    rng=np.random.RandomState(0))
        q0 = len(prompt) + tenv.obs_length + 1
        M, L = cfg.model.mem_len, cfg.model.n_layer
        if not (q0 >= 64 and use_rel_kernel(cfg.model, q0, M + q0, "cuda")):
            raise AssertionError(f"the {q0}-token prompt prime does not "
                                 f"pass K3's gate")

        # ---- the main path, counted --------------------------------------
        _reset_launches()
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            res = evaluate_rl.main(cfg, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read_launches()
        # ------------------------------------------------------------------
        sys.stdout.write(out.getvalue())
        want = dict.fromkeys(launches, 0)
        want["flash_rel_attention"] = L
        if launches != want:
            raise AssertionError(f"kernel launches {launches}, expected "
                                 f"{want}")
        if "evaluating random init" not in out.getvalue():
            raise AssertionError("main did not take the seeded random init")
        if not (len(res) == 1 and res[0]["num_trials"] == PRELN_TRIALS
                and res[0]["length_mean"] == PRELN_STEPS
                and np.isfinite(res[0]["return_mean"])):
            raise AssertionError(f"records off: {res}")
        with open(os.path.join(out_dir, "results.output")) as f:
            if f.read().splitlines() != [json.dumps(r) for r in res]:
                raise AssertionError("results.output off")
        gc.collect()
        torch.cuda.empty_cache()

        # one steady step of the cohort, timed and profiled
        model = TransformerXL(cfg.model, cfg.vocab, device="cuda",
                              generator=torch.Generator(
                                  device="cuda").manual_seed(seed))
        tenvs = [TokenizedEnv(FakeContinuousEnv(obs_dim=17, act_dim=6,
                                                seed=i), ds)
                 for i in range(PRELN_TRIALS)]
        dec = build_decoder_for_env(model, tenvs[0], pad_buckets="default")
        if dec.use_kv_cache or dec.pad_buckets is not None:
            raise AssertionError("the pre-LN decoder takes the ring")
        sep = np.full((PRELN_TRIALS, 1), tenvs[0].separator_id, np.int64)
        act, mems = dec.decode(_start_primes(tenvs, sep, seed),
                               dec.init_mems(PRELN_TRIALS))
        steady_ms = []
        for _ in range(4):
            prime = _step_obs(tenvs, act, sep)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            act, mems = dec.decode(prime, mems)
            steady_ms.append((time.perf_counter() - t0) * 1e3)
        prime = _step_obs(tenvs, act, sep)
        busy, top, step_s, host = _profile_busy(
            lambda: dec.decode(prime, mems))
        del model, dec, mems
        gc.collect()
        torch.cuda.empty_cache()
        k3 = _rel_case(fra, B=PRELN_TRIALS, qlen=q0, klen=M + q0, mem_len=M,
                       same_length=True, seed=59, timed=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    step_med = float(np.median(steady_ms))
    return {"phase": "serve_preln", "config": "db1_1p2b pre_lnorm",
            "dtype": "bfloat16", "param_dtype": "bfloat16", "card": smi,
            "hidden_vs_ring": check, "batch": PRELN_TRIALS,
            "env_steps": PRELN_STEPS, "prompt_prime_q": q0,
            "launches": launches, "launches_expected": want,
            "records": res, "wall_s": wall,
            "actions_per_sec": PRELN_TRIALS * PRELN_STEPS / wall,
            "steady_step_ms": steady_ms, "steady_step_ms_median": step_med,
            "steady_actions_per_sec": PRELN_TRIALS / step_med * 1e3,
            "profiled_step_ms": step_s * 1e3,
            "device_busy_ms": busy * 1e3,
            "device_idle_share": 1.0 - busy / step_s,
            "top_device_ms": top, "host_top_ms": host,
            "k3_prompt_case": k3}


DP_WORLD = 2
DP_TIMEOUT_S = 600
# the DP step's optimizer: the chain's SGD at a constant lr of 1 without
# the clip, so that the update is the reduced gradient itself, its scale
# included (the model-gradient gates apply to it: a gradient averaged
# over the ranks or reduced twice moves its norm by 2x; Adam's first step
# is the sign of the gradient, which near-zero elements flip), and large
# enough to read in f32 parameters
DP_OPT = dict(optimizer="sgd", lr=1.0, min_lr=1.0, lr_decay_style="constant",
              lr_warmup_iters=0, clip_grad=0.0)
# the DP loss against the one-process loss on the same batch: the same
# bf16 forward on half the rows, the masked sums in f32 over another
# split. Readings on an H100 80GB HBM3 (700 W), two runs: 9.5e-7 and 0.0.
# A mean of the ranks' own masked means (DDP's loss) must miss it by more
# on the phase's batch, so that the gate bites.
DP_LOSS_TOL = 1e-4
DP_NOTE = ("the step of one rank while the other shares the card; gloo sums "
           "the gradients through host memory: not a data-parallel rate")


def _dp_model(weights: str, device="cuda"):
    """(cfg, model): db1_1p2b (bf16 activations, f32 parameters) without
    dropout and with DP_OPT, holding the weights saved at ``weights``."""
    from bdm_db1_tpu_torch.core.config import db1_1p2b
    from bdm_db1_tpu_torch.models.transformer_xl import TransformerXL

    cfg = db1_1p2b(drop=0.0, embd_pdrop=0.0, dropattn=0.0)
    cfg.train = dataclasses.replace(cfg.train, optimizer=dataclasses.replace(
        cfg.train.optimizer, **DP_OPT))
    model = TransformerXL(cfg.model, cfg.vocab, device=device)
    model.load_state_dict(torch.load(weights, map_location=device,
                                     mmap=True))
    return cfg, model


def _halve_rank1_counts(mask: np.ndarray) -> None:
    """In place on a loss mask [accum, micro, L]: rank 1's rows of each
    micro-batch keep only their first c // 2 masked positions, c being
    rank 0's count there, so that the ranks' counts differ whatever the
    loader drew (the RL rows' counts are few values, and often equal)."""
    n = mask.shape[1] // DP_WORLD
    for a in range(mask.shape[0]):
        keep = int(mask[a, :n].sum()) // 2
        flat = mask[a, n:2 * n].reshape(-1).copy()
        flat[np.flatnonzero(flat)[keep:]] = 0
        mask[a, n:2 * n] = flat.reshape(n, -1)


def _dp_rows(raw: dict, rank: int) -> dict:
    """This rank's block of rows of each micro-batch of a loader batch."""
    out = {}
    for m, fields in raw.items():
        n = next(iter(fields.values())).shape[1] // DP_WORLD
        out[m] = {k: v[:, rank * n:(rank + 1) * n] for k, v in fields.items()}
    return out


def _param_bits(model) -> dict:
    """Per parameter, the int64 sum of its raw f32 bits."""
    return {n: int(p.detach().view(torch.int32).sum(dtype=torch.int64))
            for n, p in model.named_parameters()}


def _dp_train_rank(rank: int, world: int, weights: str, batch_file: str,
                   ckpt_dir: str) -> dict:
    """One rank of the DP step: its rows of each micro-batch through
    ``make_train_step`` under the gloo group (a warm-up forward and
    backward first, no reduce), counted and timed; the ranks' parameter
    bits exchanged; the gradient reduce timed alone; then the collective
    checkpoint of step 1."""
    import torch.distributed as dist

    from bdm_db1_tpu_torch.parallel.distributed import (
        COLLECTIVES, all_reduce_flat,
    )
    from bdm_db1_tpu_torch.train.checkpoint import CheckpointManager
    from bdm_db1_tpu_torch.train.step import (
        init_train_state, make_loss_fn, make_train_step, micro_batch,
    )
    from bdm_db1_tpu_torch.train.trainer import to_gato_batch

    cfg, model = _dp_model(weights)
    with np.load(batch_file) as f:
        raw = {"rl": {k: f[k] for k in f.files}}
    batch = to_gato_batch(_dp_rows(raw, rank), "cuda")
    counts = [float(c) for c in batch["rl"].loss_mask.sum(dim=(1, 2))]
    state = init_train_state(model, cfg.train.optimizer,
                             cfg.train.train_iters)
    step = make_train_step(model)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = [p for p in model.parameters() if p.requires_grad]
    loss = make_loss_fn(model)(micro_batch(batch, 0), gen)
    torch.autograd.grad(loss, params, allow_unused=True)
    del loss
    torch.cuda.synchronize()
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    # ---- the main path, counted ------------------------------------------
    _reset_launches()
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0
    t0 = time.perf_counter()
    state, met = step(state, batch, gen)
    loss = float(met["loss"])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    launches = _read_launches()
    # ----------------------------------------------------------------------
    collectives = dict(COLLECTIVES)
    peak = torch.cuda.max_memory_allocated()
    bits = [None] * world
    dist.all_gather_object(bits, _param_bits(model))
    # the gradient reduce alone: the same buckets, of zeros
    zeros = [torch.zeros_like(p) for n, p in model.named_parameters()
             if not n.startswith("vision_encoder.")]
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    all_reduce_flat(zeros)
    torch.cuda.synchronize()
    reduce_ms = (time.perf_counter() - t0) * 1e3
    del zeros
    t0 = time.perf_counter()
    CheckpointManager(ckpt_dir).save(1, state, client_state={"iteration": 1})
    save_s = time.perf_counter() - t0
    return {"rank": rank, "loss": loss, "loss_mask_counts": counts,
            "launches": launches, "collectives": collectives,
            "step_ms": step_ms, "step_ms_is": DP_NOTE,
            "gradient_reduce_alone_ms": reduce_ms,
            "max_memory_allocated_gb": peak / 1e9,
            "params_bitwise_equal_across_ranks": all(
                b == bits[0] for b in bits),
            "checkpoint_save_s": save_s}


def _dp_eval_rank(rank: int, world: int, cfg, seed: int) -> dict:
    """One rank of the RL evaluation world: ``evaluate_rl.main`` (counted)
    over this rank's shard of the envs, registered here."""
    from bdm_db1_tpu_torch.eval import evaluate_rl
    from bdm_db1_tpu_torch.eval.harness import shard_envs

    _register_eval_envs(seed)
    # ---- the main path, counted ------------------------------------------
    _reset_launches()
    t0 = time.perf_counter()
    records = evaluate_rl.main(cfg, device="cuda:0")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_launches()
    # ----------------------------------------------------------------------
    return {"rank": rank, "records": records, "launches": launches,
            "shard": shard_envs(list(cfg.eval.env_names)), "wall_s": wall}


def _dp_child(fn_name: str, rank: int, world: int, work: str,
              args: tuple, backend: str = "gloo") -> None:
    """A process of a gloo world on cuda:0, or of an NCCL world on
    cuda:<rank> (a ``file://`` store in ``work``): this module's
    ``fn_name(rank, world, *args)``, its result to ``<work>/<rank>.json``,
    its output to ``<work>/<rank>.log``, a failure's traceback to
    ``<work>/<rank>.err``."""
    import datetime
    import traceback

    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with open(os.path.join(work, f"{rank}.log"), "w") as log, \
                contextlib.redirect_stdout(log):
            torch.cuda.set_device(rank if backend == "nccl" else 0)
            dist.init_process_group(
                backend, init_method="file://" + os.path.join(work, "store"),
                rank=rank, world_size=world,
                timeout=datetime.timedelta(seconds=DP_TIMEOUT_S))
            out = globals()[fn_name](rank, world, *args)
        with open(os.path.join(work, f"{rank}.json"), "w") as f:
            json.dump(out, f)
    except BaseException:
        with open(os.path.join(work, f"{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _run_world(fn_name: str, work: str, *args, world: int = DP_WORLD,
               backend: str = "gloo") -> list:
    """``fn_name`` in ``world`` processes started by the spawn method (each
    process is stopped before this returns; ``_dp_child``); their results
    in rank order, or a ``RuntimeError`` with the exit codes and every
    failing rank's traceback."""
    import multiprocessing

    sub = tempfile.mkdtemp(prefix=fn_name + "_", dir=work)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_dp_child,
                         args=(fn_name, r, world, sub, args, backend))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + DP_TIMEOUT_S
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    errs = [(r, os.path.join(sub, f"{r}.err")) for r in range(world)]
    failed = "".join(f"\nrank {r}:\n{open(e).read()}" for r, e in errs
                     if os.path.exists(e))
    if failed or any(codes):
        raise RuntimeError(f"{fn_name}: exit codes {codes}{failed}")
    out = []
    for r in range(world):
        with open(os.path.join(sub, f"{r}.json")) as f:
            out.append(json.load(f))
    return out


def _update_agreement(model, one_after: dict, before: dict) -> dict:
    """Cosine and relative norm difference of the update that ``model``
    holds (its weights minus ``before``) and ``one_after`` minus
    ``before``, over the parameters the step moved."""
    return _delta_agreement(dict(model.named_parameters()), one_after,
                            before)


def _delta_agreement(after: dict, one_after: dict, before: dict) -> dict:
    """``_update_agreement`` of the parameters ``after`` (by name)."""
    return _agreement(_delta_sums(after, one_after, before))


def _delta_sums(after: dict, one_after: dict, before: dict) -> list:
    """[u . o, |u|^2, |o|^2] over the parameters ``after`` (by name), u
    their update from ``before`` and o that of ``one_after``, in f64 on
    each parameter's device."""
    dot = nd = no = 0.0
    for n, p in after.items():
        b = before[n].to(p.device)
        du = (p.detach() - b).double()
        ou = (one_after[n].to(p.device) - b).double()
        dot += float((du * ou).sum())
        nd += float(du.square().sum())
        no += float(ou.square().sum())
    return [dot, nd, no]


def _agreement(sums) -> dict:
    """Cosine and relative norm difference from ``_delta_sums``'s sums."""
    dot, nd, no = sums
    nd, no = nd ** 0.5, no ** 0.5
    return {"update_cosine": dot / (nd * no),
            "update_norm_rel_diff": abs(nd - no) / no, "update_norm": no}


def phase_data_parallel(smi: str, seed: int = 0) -> dict:
    """Data parallelism in a world of two processes on the one card (gloo;
    NCCL refuses two ranks on one device). The train phase's batch (2
    micro-batches x 4 x 1024 of its dataset, rank 1's loss-mask counts cut
    to half of rank 0's), db1_1p2b without dropout from weights this
    process saves: each rank takes one ``make_train_step`` step on its 2
    rows a micro-batch (K3/K4/K5 48 each), the ranks' parameters must end
    bitwise equal, and both write the step-1 checkpoint collectively. Then
    this process takes the one-process step on the whole batch from the
    same weights: the DP loss within DP_LOSS_TOL of it, and the mean of
    the ranks' own masked means (DDP's loss) further than DP_LOSS_TOL and
    than the DP loss from it, the DP update (read from the
    checkpoint; SGD without the clip, so the reduced gradient) at a cosine
    of at least GRAD_COS_MIN and a norm within GRAD_NORM_RTOL of it.
    Then the same step in a one-rank NCCL group: its reduce runs and its
    loss is bitwise the one-process loss. Last, ``evaluate_rl.main`` in a new two-rank world serving the
    DP checkpoint (the evaluate_rl phase's envs and config, one env a
    rank): rank 0's records are the union of the shards in rank-major
    order, each rank's equal a one-process run over its shard alone, with
    the same K1/K2 launches, and results.output holds them once."""
    import torch.distributed as dist

    from bdm_db1_tpu_torch.eval import evaluate_rl
    from bdm_db1_tpu_torch.ops import cuda_build
    from bdm_db1_tpu_torch.parallel.distributed import COLLECTIVES
    from bdm_db1_tpu_torch.train.checkpoint import load_model
    from bdm_db1_tpu_torch.train.step import (
        init_train_state, make_loss_fn, make_train_step, micro_batch,
    )
    from bdm_db1_tpu_torch.train.trainer import to_gato_batch

    cuda_build.build_libraries(SOURCES)      # once, before the ranks load
    work = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    try:
        weights = os.path.join(work, "weights.pt")
        batch_file = os.path.join(work, "batch.npz")
        ckpt_dir = os.path.join(work, "ckpt")
        _, model, _, loader = _train_setup(seed, drop=0.0, embd_pdrop=0.0,
                                           dropattn=0.0)
        try:
            raw = next(loader)["rl"]
        finally:
            loader.stop()
        _halve_rank1_counts(raw["loss_mask"])
        np.savez(batch_file, **raw)
        before = {n: t.to("cpu", copy=True)
                  for n, t in model.state_dict().items()}
        torch.save(before, weights)
        del model
        gc.collect()
        torch.cuda.empty_cache()

        # ---- two ranks on cuda:0 (counted in each rank) ------------------
        t0 = time.perf_counter()
        ranks = _run_world("_dp_train_rank", work, weights, batch_file,
                           ckpt_dir)
        world_s = time.perf_counter() - t0
        counts = [r["loss_mask_counts"] for r in ranks]
        want = dict.fromkeys(ranks[0]["launches"], 0)
        cfg, model = _dp_model(weights)
        L = cfg.model.n_layer
        for name in ("flash_rel_attention", "flash_rel_attention_bwd_dq",
                     "flash_rel_attention_bwd_dkv"):
            want[name] = L * TRAIN_ACCUM
        if not (all(r["launches"] == want for r in ranks)
                and all(r["params_bitwise_equal_across_ranks"]
                        for r in ranks)
                and ranks[0]["loss"] == ranks[1]["loss"]
                and all(r["collectives"]["all_reduce"] > TRAIN_ACCUM
                        for r in ranks)
                and all(a != b for a, b in zip(*counts))):
            raise AssertionError(f"data-parallel ranks: {ranks}")

        # ---- DDP's loss: the mean of the ranks' own masked means ---------
        # (no process group here: each micro-batch's mean is the rank's)
        loss_fn = make_loss_fn(model)
        means = []
        with torch.no_grad():
            for r in range(DP_WORLD):
                rows_r = to_gato_batch(_dp_rows({"rl": raw}, r), "cuda")
                for a in range(TRAIN_ACCUM):
                    g = torch.Generator(device="cuda").manual_seed(0)
                    means.append(float(loss_fn(micro_batch(rows_r, a), g)))
                del rows_r
        loss_mom = float(np.mean(means))

        # ---- the one-process step on the whole batch ---------------------
        batch = to_gato_batch({"rl": raw}, "cuda")
        gen = torch.Generator(device="cuda").manual_seed(0)
        step = make_train_step(model)
        state = init_train_state(model, cfg.train.optimizer,
                                 cfg.train.train_iters)
        _, met = step(state, batch, gen)
        loss_one = float(met["loss"])
        one_after = {n: p.detach().clone()
                     for n, p in model.named_parameters()}
        load_model(model, os.path.join(ckpt_dir, "1"))
        agree = _update_agreement(model, one_after, before)
        del one_after
        loss_diff = abs(ranks[0]["loss"] - loss_one)
        mom_diff = abs(loss_mom - loss_one)
        if not (loss_diff <= DP_LOSS_TOL and mom_diff > DP_LOSS_TOL
                and mom_diff > loss_diff
                and agree["update_cosine"] >= GRAD_COS_MIN
                and agree["update_norm_rel_diff"] <= GRAD_NORM_RTOL):
            raise AssertionError(f"DP step against the one-process step: "
                                 f"loss {ranks[0]['loss']} / {loss_one}, "
                                 f"mean of the ranks' means {loss_mom}, "
                                 f"{agree}")

        # ---- NCCL at world size 1 (counted) ------------------------------
        model.load_state_dict(before)
        state = init_train_state(model, cfg.train.optimizer,
                                 cfg.train.train_iters)
        dist.init_process_group(
            "nccl", init_method="file://" + os.path.join(work, "nccl"),
            rank=0, world_size=1)
        try:
            for k in COLLECTIVES:
                COLLECTIVES[k] = 0
            _reset_launches()
            _, met = step(state, batch, gen)
            loss_nccl = float(met["loss"])
            torch.cuda.synchronize()
            nccl_launches = _read_launches()
            nccl = {"backend": dist.get_backend(), "loss": loss_nccl,
                    "loss_bitwise_one_process": loss_nccl == loss_one,
                    "collectives": dict(COLLECTIVES),
                    "launches": nccl_launches}
        finally:
            dist.destroy_process_group()
        if not (nccl["loss_bitwise_one_process"]
                and nccl["collectives"]["all_reduce"] > TRAIN_ACCUM
                and nccl_launches == want):
            raise AssertionError(f"NCCL at world size 1: {nccl}")
        del model, state, batch
        gc.collect()
        torch.cuda.empty_cache()

        # ---- RL evaluation in a two-rank world (counted in each rank) ----
        cache_dir = os.path.join(work, "rl")
        _register_eval_envs(seed, cache_dir)
        ecfg = _eval_cfg(cache_dir, ckpt_dir, os.path.join(work, "out_dp"))
        t0 = time.perf_counter()
        evals = _run_world("_dp_eval_rank", work, ecfg, seed)
        eval_world_s = time.perf_counter() - t0
        alone = []
        for r in evals:
            cfg_r = dataclasses.replace(ecfg, eval=dataclasses.replace(
                ecfg.eval, env_names=tuple(r["shard"])),
                train=dataclasses.replace(ecfg.train, save_dir=os.path.join(
                    work, f"out_{r['rank']}")))
            _reset_launches()
            with contextlib.redirect_stdout(io.StringIO()):
                records = evaluate_rl.main(cfg_r, device="cuda")
            alone.append({"records": records, "launches": _read_launches()})
        union = [rec for a in alone for rec in a["records"]]
        with open(os.path.join(work, "out_dp", "results.output")) as f:
            lines = f.read().splitlines()
        if not ([r["shard"] for r in evals] == [[n] for n in EVAL_ENVS]
                and all(r["records"] == union for r in evals)
                and lines == [json.dumps(rec) for rec in union]
                and all(r["launches"] == a["launches"]
                        and r["launches"]["flash_ring_decode"] > 0
                        and r["launches"]["flash_ring_prime_ap"] > 0
                        for r, a in zip(evals, alone))):
            raise AssertionError(f"evaluation world: {evals}, one process "
                                 f"a shard: {alone}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    launches = {k: sum(r["launches"][k] for r in ranks + evals)
                + nccl_launches[k] for k in want}
    return {"phase": "data_parallel", "config": "db1_1p2b", "card": smi,
            "world": DP_WORLD, "backend": "gloo, the ranks on cuda:0",
            "dtype": "bfloat16", "param_dtype": "float32",
            "dropout": 0.0, "optimizer": DP_OPT,
            "micro_batch_per_rank": TRAIN_MICRO // DP_WORLD,
            "accum": TRAIN_ACCUM, "seq_length": raw["label"].shape[-1],
            "loss_mask_counts": counts, "ranks": ranks,
            "world_s": world_s, "loss_one_process": loss_one,
            "loss_abs_diff": loss_diff, "loss_tol": DP_LOSS_TOL,
            "loss_mean_of_rank_means": loss_mom,
            "mean_of_means_abs_diff": mom_diff,
            "update": agree, "update_cosine_min": GRAD_COS_MIN,
            "nccl_world_1": nccl,
            "evaluate_rl": {"envs": list(EVAL_ENVS), "trials": EVAL_TRIALS,
                            "env_steps": EVAL_STEPS, "ranks": [
                                {k: r[k] for k in ("rank", "shard",
                                                   "launches", "wall_s")}
                                for r in evals],
                            "records": union, "world_s": eval_world_s},
            "launches": launches}


# ---- tensor parallelism ----------------------------------------------------

TP_WORLD = 2
TP_H = 16 // TP_WORLD          # db1_1p2b's heads on a rank at tp 2
TP_MICRO = 2                   # train's micro-batch: 2 rows x 1024
# the trunk matrices (K, N) of a rank at tp 2: qkv_net and CoreNet.0
# column-parallel (N / 2), o_net and CoreNet.2 row-parallel (K / 2)
TP_TRUNK = {"qkv_net": (2048, 3072), "o_net": (1024, 2048),
            "CoreNet.0": (2048, 4096), "CoreNet.2": (2048, 2048)}
TP_SERVE_B = len(EVAL_ENVS) * EVAL_TRIALS   # 40 envs, one cohort
TP_SERVE_STEPS = 4
TP_CHECK_B = 8                 # the rows of the logits and chain checks
TP_CHAIN_STEPS = 2
# the layers held one by one from one input, tp against one process
TP_LAYERS = (0, 11, 23)
TP_GRAD_SEED = 7               # their upstream gradients
# the ring layers' widths: a 256-token slice of the expert prompt (the
# plain ring branch), the bucketed prime (K2/K7) and the decode (K1/K6)
TP_RING_WIDTHS = (256, 24, 1)
# The bf16 tp step's update against the one-process bf16 step's. Sound
# readings (H100, six runs): cosine 0.973-0.981, norms 0.0008-0.015
# apart; the one-process bf16 step is as far from its f32 step (cosine
# 0.969-0.973). The limits leave three to four times that gap.
TP_BF16_UPDATE_COS_MIN = 0.9
TP_BF16_UPDATE_NORM_RTOL = 5e-2
# The f32 tp step's update against the one-process f32 step's: only the
# order of the partial sums differs (readings, H100: cosine 1 - 1.8e-9,
# norms 1e-6 to 7e-6 apart); a collective left out moves it far more.
TP_F32_UPDATE_COS_MIN = 1 - 1e-6
TP_F32_UPDATE_NORM_RTOL = 1e-4
# The tensor-parallel serve against one process. In bf16 a rank's partial
# sums round once after their f32 sum, where one product rounds once: a
# layer's outputs move by a bf16 ulp here and there (the layer checks read
# 0.006 of the maximum), and 24 random-init layers grow that as far as
# bf16 is from f32 (the phase prints both end to end; PERF.md §6). So, as
# the repo's other bf16 gates do:
# in bf16 each layer from one input within ATTN_REL_TOL, the route gate;
# end to end on f32 copies, the first action's logits within
# BUCKET_LOGIT_TOL of their maximum (only rounding differs) and at least
# TP_ACTION_SHARE of a TP_CHAIN_STEPS-step greedy chain's actions equal.
# The bf16 end-to-end readings are printed beside them.
TP_ACTION_SHARE = 0.9
TP_NOTE = ("the step of one rank while the other shares the card; gloo sums "
           "each layer's partial activations through host memory: not a "
           "tensor-parallel rate")


def _tp_kernels(old_rel_bwd=None) -> dict:
    """Every kernel of the tensor-parallel paths at the shapes of a rank at
    tp 2 (H 8 heads), held to its plain version and timed: K1 and K2 (Q
    24, the steady prime's bucket) on the bf16 cache of the 40-env serve,
    K6 and K7 (and K8 beside K7) on its int8 cache, K9 at the four local
    trunk matrices at 40 rows (q = 1) and qkv_net at 960 (the bucketed
    prime; K 1024 and 2048 for the planner's split), K3 and the backward
    (K4, K5) at the train micro-batch, 2 x 1024."""
    from bdm_db1_tpu_torch.ops import flash_rel_attention as fra
    from bdm_db1_tpu_torch.ops import flash_ring_decode as fro
    from bdm_db1_tpu_torch.ops import quant_matmul as qm

    full = dict(L=24, B=TP_SERVE_B, M=1024, H=TP_H, Dh=128, layer=17)
    full8 = dict(full, int8=True)
    qmm = [_qmm_case(qm, R=TP_SERVE_B, K=K, N=N, seed=110 + i, timed=True)
           for i, (K, N) in enumerate(TP_TRUNK.values())]
    qmm.append(_qmm_case(qm, R=24 * TP_SERVE_B, K=2048, N=3072, seed=115,
                         timed=True))
    out = {
        "flash_ring_decode": _kernel_case(fro, Q=None, seed=101, timed=True,
                                          **full),
        "flash_ring_prime_ap": _kernel_case(fro, Q=24, seed=102, timed=True,
                                            **full),
        "flash_ring_decode_int8": _kernel_case(fro, Q=None, seed=103,
                                               timed=True, **full8),
        "flash_ring_prime_ap_int8": _kernel_case(fro, Q=24, seed=104,
                                                 timed=True, **full8),
        "quant_matmul": qmm,
        "flash_rel_attention": _rel_case(
            fra, B=TP_MICRO, qlen=1024, klen=1024, mem_len=1024,
            same_length=True, seed=105, timed=True, H=TP_H),
        "flash_rel_attention_bwd": _rel_bwd_case(
            fra, B=TP_MICRO, qlen=1024, klen=1024, mem_len=1024,
            same_length=True, seed=106, timed=True, H=TP_H,
            old=old_rel_bwd)}
    torch.cuda.empty_cache()
    return out


def _tp_model(cfg, tp, weights: str):
    """db1_1p2b of ``cfg`` holding this rank's shard of the whole weights
    saved at ``weights`` (the whole weights without ``tp``)."""
    from bdm_db1_tpu_torch.models.transformer_xl import TransformerXL
    from bdm_db1_tpu_torch.train.convert import load_into

    model = TransformerXL(cfg.model, cfg.vocab, device="cuda", tp=tp)
    load_into(model, torch.load(weights, map_location="cpu", mmap=True))
    return model


class _CollectiveLog:
    """Records the all_reduce and all_gather calls of the process (the
    tensors' shapes and dtypes) while on, and replays them alone on
    zeros."""

    def __init__(self):
        import torch.distributed as dist

        self.dist = dist
        self.calls = []
        self._orig = {}
        self.device = "cuda"

    def __enter__(self):
        for name in ("all_reduce", "all_gather"):
            fn = getattr(self.dist, name)
            self._orig[name] = fn

            def rec(*a, _fn=fn, _name=name, **kw):
                t = a[1] if _name == "all_gather" else a[0]
                self.calls.append((_name, tuple(t.shape), t.dtype,
                                   kw.get("group")))
                return _fn(*a, **kw)

            setattr(self.dist, name, rec)
        return self

    def __exit__(self, *exc):
        for name, fn in self._orig.items():
            setattr(self.dist, name, fn)

    def replay_ms(self) -> float:
        """The recorded collectives again, alone, on zeros on the card."""
        bufs = []
        for name, shape, dtype, group in self.calls:
            t = torch.zeros(shape, dtype=dtype, device=self.device)
            n = self.dist.get_world_size(group)
            bufs.append((name, t, group,
                         [torch.empty_like(t) for _ in range(n)]))
        torch.cuda.synchronize()
        self.dist.barrier()
        t0 = time.perf_counter()
        for name, t, group, parts in bufs:
            if name == "all_reduce":
                self.dist.all_reduce(t, group=group)
            else:
                self.dist.all_gather(parts, t, group=group)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3


def _tp_cfg(dtype: str):
    """db1_1p2b with ``dtype`` activations and f32 parameters, no dropout,
    the DP step's optimizer (SGD lr 1 without the clip)."""
    from bdm_db1_tpu_torch.core.config import db1_1p2b

    cfg = db1_1p2b(drop=0.0, embd_pdrop=0.0, dropattn=0.0, dtype=dtype)
    cfg.train = dataclasses.replace(cfg.train, optimizer=dataclasses.replace(
        cfg.train.optimizer, **DP_OPT))
    return cfg


def _set_dtype(model, dtype: str) -> None:
    """Switch a model's activations to ``dtype`` in place (its parameters
    are f32 here, so one model takes the bf16 and the f32 steps)."""
    model.cfg.dtype = dtype
    model.dtype = getattr(torch, dtype)


def _layer_grads(layer, h, r, mask, g):
    """One decoder layer forward from ``h`` on the kernel route and its
    backward from the upstream gradient ``g``: (output, input gradient,
    {parameter name: gradient}), outputs and input gradient in f32."""
    x = h.detach().requires_grad_(True)
    params = dict(layer.named_parameters())
    y = layer(x, None, r, mask, True)
    grads = torch.autograd.grad(y, [x, *params.values()], g,
                                allow_unused=True)
    return (y.detach().float(), grads[0].float(),
            {n: d for n, d in zip(params, grads[1:]) if d is not None})


def _tp_layers(model, one, tp, batch) -> list:
    """TP_LAYERS of the bf16 tp model from one input (the first
    micro-batch embedded), on the kernel route, forward and backward from
    one seeded upstream gradient: K3 forward and K4/K5 backward on the
    rank's heads, the column-parallel products' input gradient summed
    over the model group. Rank 0 (``one``, the one-process model) runs the
    same layer on the same input and gradient: max |diff| / max |ref| of
    the output (``rel_diff``) and of the input gradient
    (``dx_rel_diff``), and ``_grad_agreement`` of the parameter gradients
    (the rank's shards gathered whole) each (rank 0's list)."""
    from bdm_db1_tpu_torch.models.transformer_xl import use_rel_kernel
    from bdm_db1_tpu_torch.ops.attention import same_length_mask
    from bdm_db1_tpu_torch.ops.positional import relative_positional_embedding
    from bdm_db1_tpu_torch.parallel.mesh import gather_state_dict
    from bdm_db1_tpu_torch.train.step import micro_batch

    cfg = model.cfg
    with torch.no_grad():
        h = model.embed_concat(micro_batch(batch, 0), with_targets=False)[0]
    qlen = h.shape[1]
    mask = same_length_mask(qlen, qlen, cfg.mem_len, device="cuda")
    r = relative_positional_embedding(qlen, cfg.n_embed,
                                      cfg.effective_clamp_len, device="cuda")
    if not use_rel_kernel(cfg, qlen, qlen, "cuda"):
        raise AssertionError("the tp layer check does not take K3")
    gen = torch.Generator(device="cuda").manual_seed(TP_GRAD_SEED)
    out = []
    for li in TP_LAYERS:
        g = torch.randn(h.shape, device="cuda", generator=gen).to(h.dtype)
        got, dx, grads = _layer_grads(model.h[li], h, r, mask, g)
        grads = gather_state_dict(grads, tp, cfg)
        if one is not None:
            want, dx1, grads1 = _layer_grads(one.h[li], h, r, mask, g)
            out.append(dict(
                layer=li,
                rel_diff=float((got - want).abs().max() / want.abs().max()),
                dx_rel_diff=float((dx - dx1).abs().max() / dx1.abs().max()),
                params=len(grads1),
                **_grad_agreement([grads.get(n) for n in grads1],
                                  list(grads1.values()))))
            del want, dx1, grads1
        del got, dx, grads
    return out


def _tp_layers_ok(layers: list) -> bool:
    """Each TP_LAYERS entry of ``_tp_layers`` within its gates."""
    return (len(layers) == len(TP_LAYERS)
            and all(x["rel_diff"] <= ATTN_REL_TOL
                    and x["dx_rel_diff"] <= GRAD_REL_TOL
                    and x["grad_cosine"] >= GRAD_COS_MIN
                    and x["grad_norm_rel_diff"] <= GRAD_NORM_RTOL
                    and x["params"] > 10 for x in layers))


def _sgd_step(model, batch) -> float:
    """One ``make_train_step`` step of ``model`` (its config's SGD) from
    the seed-0 generator; the loss."""
    from bdm_db1_tpu_torch.train import step as tstep

    state = tstep.init_train_state(model, _tp_cfg("float32").train.optimizer,
                                   1)
    _, met = tstep.make_train_step(model)(
        state, batch, torch.Generator(device="cuda").manual_seed(0))
    return float(met["loss"])


class OneProcessReference:
    """The one-process steps that the tensor_parallel and pipeline phases
    hold their worlds to, made once a process and seed (the two phases
    share them): db1_1p2b without dropout from the seed's random weights
    and the train phase's first micro-batch cut to TP_MICRO rows (both to
    files the worlds read), then from those weights one ``make_train_step``
    step (DP_OPT) with f32 activations and one with bf16: their losses and
    parameters after (files), how far the bf16 step lands from the f32
    one, and the bf16 hidden state after the first PP_LAYERS layers on
    each pipeline micro-batch's rows (a file). ``close`` deletes the
    files."""

    def __init__(self):
        self.dir = None
        self.runs = {}

    def get(self, seed: int) -> dict:
        if seed not in self.runs:
            if self.dir is None:
                self.dir = tempfile.mkdtemp(prefix="chip_smoke_ref_")
            self.runs[seed] = self._make(seed)
            gc.collect()
            torch.cuda.empty_cache()
        return self.runs[seed]

    def close(self) -> None:
        if self.dir is not None:
            shutil.rmtree(self.dir, ignore_errors=True)

    def _make(self, seed: int) -> dict:
        from bdm_db1_tpu_torch.train.trainer import to_gato_batch

        t0 = time.perf_counter()
        out = {k: os.path.join(self.dir, f"{seed}_{k}") for k in (
            "weights.pt", "batch.npz", "f32_after.pt", "bf16_after.pt",
            "stage_rows.pt")}
        _, model, _, loader = _train_setup(seed, drop=0.0, embd_pdrop=0.0,
                                           dropattn=0.0)
        try:
            # one micro-batch of 2 rows: each step's collectives go
            # through gloo on the one card
            raw = {k: v[:1, :TP_MICRO]
                   for k, v in next(loader)["rl"].items()}
        finally:
            loader.stop()
        np.savez(out["batch.npz"], **raw)
        before = {n: t.to("cpu", copy=True)
                  for n, t in model.state_dict().items()}
        torch.save(before, out["weights.pt"])
        batch = to_gato_batch({"rl": raw}, "cuda")
        torch.save(_stage_rows(model, batch), out["stage_rows.pt"])
        _set_dtype(model, "float32")
        out["f32_loss"] = _sgd_step(model, batch)
        after32 = {n: p.detach().to("cpu", copy=True)
                   for n, p in model.named_parameters()}
        torch.save(after32, out["f32_after.pt"])
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(before[n])
        _set_dtype(model, "bfloat16")
        out["bf16_loss"] = _sgd_step(model, batch)
        torch.save({n: p.detach().to("cpu", copy=True)
                    for n, p in model.named_parameters()},
                   out["bf16_after.pt"])
        out["bf16_vs_f32_loss_abs_diff"] = abs(out["bf16_loss"]
                                               - out["f32_loss"])
        out["bf16_vs_f32_update"] = _update_agreement(model, after32, before)
        out["micro_batch"] = TP_MICRO
        out["seconds"] = time.perf_counter() - t0
        return out


def _stage_rows(model, batch) -> list:
    """The bf16 hidden state after the first PP_LAYERS layers of ``model``
    (no dropout, the trunk's route: K3 at 1024) on the rows of each of
    PP_MICRO pipeline micro-batches of the first micro-batch (row b in
    micro-batch b % PP_MICRO), on the host: what stage 0 of a pipeline
    over PP_WORLD stages sends."""
    from bdm_db1_tpu_torch.models.transformer_xl import use_rel_kernel
    from bdm_db1_tpu_torch.ops.attention import same_length_mask
    from bdm_db1_tpu_torch.ops.positional import relative_positional_embedding
    from bdm_db1_tpu_torch.train.step import micro_batch

    cfg = model.cfg
    out = []
    with torch.no_grad():
        h = model.embed_concat(micro_batch(batch, 0), with_targets=False)[0]
        L = h.shape[1]
        mask = same_length_mask(L, L, cfg.mem_len, device="cuda")
        r = relative_positional_embedding(L, cfg.n_embed,
                                          cfg.effective_clamp_len,
                                          device="cuda")
        use_kernel = use_rel_kernel(cfg, L, L, "cuda")
        for m in range(PP_MICRO):
            x = h[m::PP_MICRO].clone(memory_format=torch.contiguous_format)
            for layer in list(model.h)[:PP_LAYERS]:
                x = layer(x, None, r, mask, use_kernel)
            out.append(x.cpu())
    return out


def _tp_reference_steps(model, tp, batch, ref: dict) -> dict:
    """The first step, not counted, from the weights, in f32 activations
    on the tp model (its parameters put back afterwards). Rank 0's
    result: the f32 losses and the agreement of the f32 update (the tp
    parameters gathered whole) with the one-process f32 step's, and the
    one-process bf16 step's loss and its update against the f32 one (how
    far bf16 alone moves it), from ``ref`` (``OneProcessReference``)."""
    from bdm_db1_tpu_torch.parallel.mesh import gather_state_dict

    snap = [p.detach().clone() for p in model.parameters()]
    _set_dtype(model, "float32")
    loss_tp = _sgd_step(model, batch)
    # copies: the replicated parameters are put back below
    after = gather_state_dict({n: p.detach().clone() for n, p in
                               model.named_parameters()}, tp, model.cfg)
    with torch.no_grad():
        for p, s in zip(model.parameters(), snap):
            p.copy_(s)
    del snap
    _set_dtype(model, "bfloat16")
    if tp.rank != 0:
        return {}
    out = {"f32": {"loss_tp": loss_tp, "loss_one_process": ref["f32_loss"],
                   "update": _delta_agreement(
                       after, torch.load(ref["f32_after.pt"],
                                         map_location="cpu", mmap=True),
                       torch.load(ref["weights.pt"], map_location="cpu",
                                  mmap=True))}}
    out["bf16"] = {"loss_one_process": ref["bf16_loss"],
                   "one_process_bf16_vs_f32_loss_abs_diff":
                   ref["bf16_vs_f32_loss_abs_diff"],
                   "one_process_bf16_vs_f32_update":
                   ref["bf16_vs_f32_update"]}
    return out


def _tp_train_rank(rank: int, world: int, ref: dict, ckpt_dir: str) -> dict:
    """One rank of the tp 2 train world: its shard of the weights of
    ``ref`` (``OneProcessReference``; rank 0 the whole model too, for the
    layer checks). Three layers against the one-process layers from one
    input (``_tp_layers``) and the reference steps
    (``_tp_reference_steps``: the gated f32 step). Then one
    ``make_train_step`` step on the whole batch (2 rows a micro-batch, no
    dropout, SGD lr 1 without the clip) in bf16, counted and timed (its
    first bf16 backward: not a rate), with its collectives recorded and
    replayed alone, its update against the one-process bf16 update (gated
    in the phase);
    the collective save of step 1; a second step with the default dropout
    rates, from the generator of data rank 0, and the replicated
    parameters' bits exchanged."""
    import torch.distributed as dist

    from bdm_db1_tpu_torch.core.config import MeshConfig, db1_1p2b
    from bdm_db1_tpu_torch.parallel.distributed import COLLECTIVES
    from bdm_db1_tpu_torch.parallel.mesh import (
        gather_state_dict, make_mesh, replicated, tensor_parallel,
    )
    from bdm_db1_tpu_torch.train.checkpoint import CheckpointManager
    from bdm_db1_tpu_torch.train.step import (
        init_train_state, make_train_rng, make_train_step,
    )
    from bdm_db1_tpu_torch.train.trainer import to_gato_batch

    stages, t0 = {}, time.perf_counter()
    weights = ref["weights.pt"]
    cfg = _tp_cfg("bfloat16")
    tp = tensor_parallel(make_mesh(MeshConfig(model_parallel=world), "cuda"))
    model = _tp_model(cfg, tp, weights)
    one = _tp_model(_tp_cfg("bfloat16"), None, weights) if rank == 0 else None
    with np.load(ref["batch.npz"]) as f:
        batch = to_gato_batch({"rl": {k: f[k] for k in f.files}}, "cuda")
    stages["load_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    layers = _tp_layers(model, one, tp, batch)
    stages["layers_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    del one
    gc.collect()
    torch.cuda.empty_cache()
    steps_ref = _tp_reference_steps(model, tp, batch, ref)
    stages["reference_steps_s"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    state = init_train_state(model, cfg.train.optimizer,
                             cfg.train.train_iters)
    step = make_train_step(model)
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    log = _CollectiveLog()
    # ---- the main path, counted ------------------------------------------
    _reset_launches()
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0
    with log:
        t0 = time.perf_counter()
        state, met = step(state, batch, gen)
        loss = float(met["loss"])
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
    launches = _read_launches()
    # ----------------------------------------------------------------------
    collectives = dict(COLLECTIVES)
    peak = torch.cuda.max_memory_allocated()
    alone_ms = log.replay_ms()
    log.calls.clear()
    after = gather_state_dict({n: p.detach() for n, p in
                               model.named_parameters()}, tp, model.cfg)
    if rank == 0:
        steps_ref["bf16"]["loss_tp"] = loss
        steps_ref["bf16"]["loss_abs_diff"] = abs(
            loss - steps_ref["bf16"]["loss_one_process"])
        steps_ref["bf16"]["update"] = _delta_agreement(
            after, torch.load(ref["bf16_after.pt"], map_location="cpu",
                              mmap=True),
            torch.load(weights, map_location="cpu", mmap=True))
    del after
    t0 = time.perf_counter()
    CheckpointManager(ckpt_dir).save(1, state, client_state={"iteration": 1})
    save_s = time.perf_counter() - t0
    bits = _param_bits(model)
    # ---- the second step, with dropout (counted too) ---------------------
    base = db1_1p2b().model
    for name in ("drop", "embd_pdrop", "dropattn"):
        setattr(model.cfg, name, getattr(base, name))
    _reset_launches()
    state, met = step(state, batch, make_train_rng(0, "cuda", tp.data_rank))
    loss2 = float(met["loss"])
    torch.cuda.synchronize()
    launches2 = _read_launches()
    # ----------------------------------------------------------------------
    mine = {n: b for n, b in _param_bits(model).items() if replicated(n)}
    every = [None] * world
    dist.all_gather_object(every, mine)
    return {"rank": rank, "coords": [tp.data_rank, tp.rank], "loss": loss,
            "loss_dropout_step": loss2, "ref": steps_ref,
            "launches": launches, "launches_dropout_step": launches2,
            "collectives": collectives,
            "step_ms": step_ms, "step_ms_is": TP_NOTE,
            "collectives_alone_ms": alone_ms,
            "gloo_share": alone_ms / step_ms,
            "max_memory_allocated_gb": peak / 1e9,
            "checkpoint_save_s": save_s, "param_bits": bits,
            "replicated_bitwise_equal_across_ranks": all(
                e == mine for e in every),
            "replicated_params": len(mine), "layers": layers,
            "stages_s": stages}


def _tp_prime_stream(seed: int, layout) -> list:
    """TP_CHAIN_STEPS primes of TP_CHECK_B rows of the serve geometry: 17
    seeded continuous observation tokens of ``layout`` and the
    separator."""
    rng = np.random.RandomState(seed)
    return [np.concatenate([
        layout.continuous_offset + rng.randint(
            0, layout.num_continuous_bin, (TP_CHECK_B, 17)),
        np.full((TP_CHECK_B, 1), layout.separator_id)], 1).astype(np.int64)
        for _ in range(TP_CHAIN_STEPS)]


@torch.no_grad()
def _tp_decode_checks(model, primes) -> dict:
    """The first action's logits [B, V] of the first prime over the zero
    ring cache, and the greedy chain of an ``ActionDecoder`` over the
    prime stream."""
    from bdm_db1_tpu_torch.data.packing import action_flags_and_position_ids
    from bdm_db1_tpu_torch.eval.decode import ActionDecoder

    b, q = primes[0].shape
    _, pos = action_flags_and_position_ids(q, q - 1, 6, 0)
    cache = model.init_kv_cache_ring(b)
    logits, _ = model.decode_rl_kv_ring(
        torch.as_tensor(primes[0], device=model.device),
        torch.as_tensor(np.broadcast_to(pos, (b, q)).copy(),
                        device=model.device),
        cache, model.precompute_rk(q))
    dec = ActionDecoder(model, model.layout, q - 1, 6, False)
    mems, acts = dec.init_mems(b), []
    for p in primes:
        a, mems = dec.decode(p, mems)
        acts.append(a)
    return {"logits": logits.float().cpu(), "actions": np.stack(acts)}


@torch.no_grad()
def _tp_ring_layers(model, one, tp, seed: int) -> list:
    """TP_LAYERS of the ring decode from one input on the serve's route: a
    seeded [TP_CHECK_B, q, D] input over a seeded one-layer ring cache
    (cursor 5; int8 with its scales for an int8 model) at each of
    TP_RING_WIDTHS, q = 256 (a slice of the expert prompt: the plain ring
    branch), q = 24 (K2/K7) and q = 1 (K1/K6); the tp model reads its
    heads' slice of the cache. Rank 0 (``one``, the one-process model)
    runs the same layer: max |diff| / max |out| of the layer's output each
    (rank 0's list)."""
    from bdm_db1_tpu_torch.models.transformer_xl import quantize_kv_rows

    cfg = model.cfg
    B, M, H, Dh = TP_CHECK_B, cfg.mem_len, cfg.n_head, cfg.d_head
    sl = slice(tp.rank * model.heads, (tp.rank + 1) * model.heads)
    dev = model.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for q in TP_RING_WIDTHS:
        x = torch.randn(B, q, cfg.n_embed, device=dev,
                        generator=gen).to(model.dtype)
        kv = torch.randn(2, 1, B, M, H, Dh, device=dev,
                         generator=gen).to(model.dtype)
        whole = {"k": kv[0], "v": kv[1], "cursor": 5}
        if cfg.decode_cache_dtype == "int8":
            for key in ("k", "v"):
                whole[key], whole[key + "_scale"] = quantize_kv_rows(
                    whole[key])
        mine = {k: v if k == "cursor" else v[:, :, :, sl].contiguous()
                for k, v in whole.items()}
        mask, mask_s = model.ring_masks(q, 5, dev)
        rk = model.precompute_rk(q)
        rk_one = None if one is None else one.precompute_rk(q)
        route = q <= 32      # the kernels take q <= 32, as the serve's gate
        for li in TP_LAYERS:
            got = model.h[li].forward_ring(x, rk[li], mine, 0, mask, mask_s,
                                           route)[0].float()
            if one is not None:
                want = one.h[li].forward_ring(x, rk_one[li], whole, 0, mask,
                                              mask_s, route)[0].float()
                out.append({"q": q, "layer": li, "rel_diff": float(
                    (got - want).abs().max() / want.abs().max())})
    return out


def _tp_serve_checks(cfgs: dict, mesh, rank: int, primes, seed: int
                     ) -> dict:
    """The served checkpoint on each rank as its shard (rank 0: the
    one-process model too, the shard made from it): in bf16 the first
    action's logits and the greedy chain (read) and ``_tp_ring_layers``;
    on f32 copies the logits and the chain end to end; on the int8 leg's
    copies (int8 cache and weights, the weights made after sharding) the
    same bf16 readings and the ring layers."""
    from bdm_db1_tpu_torch.eval.decode import shard_decode_params
    from bdm_db1_tpu_torch.eval.evaluate_rl import load_params
    from bdm_db1_tpu_torch.models.transformer_xl import TransformerXL
    from bdm_db1_tpu_torch.parallel.mesh import tensor_parallel

    tp = tensor_parallel(mesh)
    cfg = cfgs["bf16"]
    one = None
    with contextlib.redirect_stdout(io.StringIO()):
        if rank == 0:
            one = TransformerXL(cfg.model, cfg.vocab, device="cuda")
            load_params(cfg, one)
            model = shard_decode_params(one, mesh)
        else:
            model = TransformerXL(cfg.model, cfg.vocab, device="cuda", tp=tp)
            load_params(cfg, model)

    def variant(m, c):
        """A copy of ``m`` (a shard or the one-process model) under the
        model config of ``c``."""
        if m is None:
            return None
        out = TransformerXL(c.model, c.vocab, device="cuda", tp=m.tp)
        out.load_state_dict(m.state_dict())
        if c.model.decode_weight_dtype:
            out.quantize_decode_weights()
        return out

    c32 = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, dtype="float32", param_dtype="float32"))
    checks = {}
    for name, c in (("bfloat16", None), ("float32", c32),
                    ("int8", cfgs["int8"])):
        m = model if c is None else variant(model, c)
        o = one if c is None else variant(one, c)
        res = {"tp": _tp_decode_checks(m, primes)}
        if o is not None:
            res["one"] = _tp_decode_checks(o, primes)
        if name != "float32":
            res["layers"] = _tp_ring_layers(m, o, tp, seed)
        checks[name] = res
        del m, o
        gc.collect()
        torch.cuda.empty_cache()
    return checks


def _tp_rank(rank: int, world: int, ref: dict, ckpt_dir: str, cfgs: dict,
             primes: list, seed: int) -> dict:
    """One rank of the tp 2 world: ``_tp_train_rank``, then the serve of
    its checkpoint (``_tp_serve_rank``)."""
    train = _tp_train_rank(rank, world, ref, ckpt_dir)
    gc.collect()
    torch.cuda.empty_cache()
    return {"train": train,
            "serve": _tp_serve_rank(rank, world, cfgs, primes, seed)}


def _tp_serve_rank(rank: int, world: int, cfgs: dict, primes: list,
                   seed: int) -> dict:
    """The serve on one rank of the tp 2 world: for each of ``cfgs``
    (bf16; int8 cache and weights) ``evaluate_rl.main`` with
    ``eval.sharded_decode`` (counted, its ring forwards recorded by
    width); then ``_tp_serve_checks`` on the checkpoint they served
    (compared on rank 0)."""
    import collections

    from bdm_db1_tpu_torch.eval import evaluate_rl
    from bdm_db1_tpu_torch.models.transformer_xl import TransformerXL
    from bdm_db1_tpu_torch.parallel.mesh import make_mesh

    _register_eval_envs(seed)
    widths = []
    ring_forward = TransformerXL.ring_forward

    def counting(self, h, *a, **kw):
        widths.append(int(h.shape[1]))
        return ring_forward(self, h, *a, **kw)

    out = {"rank": rank}
    for leg, cfg in cfgs.items():
        widths.clear()
        TransformerXL.ring_forward = counting
        try:
            # ---- the main path, counted ----------------------------------
            _reset_launches()
            t0 = time.perf_counter()
            records = evaluate_rl.main(cfg, device="cuda:0")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = _read_launches()
            # --------------------------------------------------------------
        finally:
            TransformerXL.ring_forward = ring_forward
        out[leg] = {"records": records, "launches": launches, "wall_s": wall,
                    "forwards": dict(collections.Counter(widths))}
    t0 = time.perf_counter()
    checks = _tp_serve_checks(cfgs, make_mesh(cfgs["bf16"].mesh, "cuda"),
                              rank, primes, seed)
    out["checks_s"] = time.perf_counter() - t0
    if rank == 0:
        out["checks"] = _tp_compare(checks)
    return out


def _tp_compare(checks: dict) -> dict:
    """``_tp_serve_checks``'s results, tp against one process: in each
    model the first action's logits (max |diff|, and over max |logit|)
    and the share of equal actions in the chain, the ring layers; the
    one-process bf16 logits against its f32 copy's."""
    out = {}
    for name, c in checks.items():
        d = (c["tp"]["logits"] - c["one"]["logits"]).abs().max()
        out[name] = {
            "logits_max_abs_diff": float(d),
            "logits_rel_diff": float(d / c["one"]["logits"].abs().max()),
            "actions_equal_share": float(np.mean(
                c["tp"]["actions"] == c["one"]["actions"]))}
        if "layers" in c:
            out[name]["layers"] = c["layers"]
    out["one_process_bf16_vs_f32_logits_max_abs_diff"] = float(
        (checks["bfloat16"]["one"]["logits"]
         - checks["float32"]["one"]["logits"]).abs().max())
    return out


def _tp_plan_ok(leg: dict, int8: bool) -> bool:
    """The serve's launches are its ring forwards' plan: a K1 (K6) launch a
    layer for every q = 1 forward, a K2 (K7) launch a layer for every
    forward of 2..32 rows, and with int8 weights a K9 launch for each of
    the four trunk matrices of every layer of every forward."""
    f = {int(k): v for k, v in leg["forwards"].items()}
    q1 = f.get(1, 0)
    prime = sum(v for k, v in f.items() if 2 <= k <= 32)
    L = 24
    sfx = "_int8" if int8 else ""
    want = {"flash_ring_decode" + sfx: L * q1,
            "flash_ring_prime_ap" + sfx: L * prime}
    if int8:
        want["quant_matmul"] = 4 * L * sum(f.values())
    return all(leg["launches"][k] == v for k, v in want.items()) and q1 > 0


def phase_tensor_parallel(smi: str, reference: "OneProcessReference",
                          seed: int = 0, old_rel_bwd=None) -> dict:
    """Tensor parallelism in a world of two processes on the one card (gloo;
    NCCL refuses two ranks on one device), tp 2, dp 1, db1_1p2b at full
    width and depth from the weights of ``reference`` (the one-process
    steps, made once for this phase and the pipeline's). First every kernel
    of the paths at a rank's shapes (H 8) against its plain version
    (``_tp_kernels``). Then each rank takes one ``make_train_step`` step on
    its shard (the train phase's first micro-batch cut to 2 rows, no
    dropout, SGD lr 1 without the clip), in bf16: K3 = K4 = K5 = 24, the
    tp checkpoint restored here in one process, its slices bit for bit
    the ranks' parameters; a second step with the default dropout leaves
    the replicated parameters bitwise equal on both ranks; three layers
    from one input and one upstream gradient against the one-process
    layers (``_tp_layers_ok``). The same first step in f32 activations:
    the loss within DP_LOSS_TOL of the one-process f32 step and the update
    (from its tp checkpoint) within TP_F32_UPDATE_COS_MIN and
    TP_F32_UPDATE_NORM_RTOL; the bf16
    step's update within TP_BF16_UPDATE_COS_MIN and
    TP_BF16_UPDATE_NORM_RTOL of the one-process bf16 step's, its loss read
    beside the one-process bf16 step's own distance from f32
    (TP_ACTION_SHARE's comment says why). Then, in the same world,
    ``evaluate_rl.main`` with ``eval.sharded_decode`` serves the bf16
    checkpoint (the evaluate_rl phase's 40 envs, 4 steps, without the
    expert prompt, whose 256-token slices would send 16 GB of f32 partial
    sums through gloo; the ring layers hold such a slice), in bf16 and on
    an int8 cache with int8 weights: each rank's launches the plan of its
    ring forwards (bf16: K1 120 and K2 24 a step), the records finite and
    written once; then on the served weights: the ring layers from one
    input in the serve's dtypes at TP_RING_WIDTHS within ATTN_REL_TOL of
    one process (the plain ring branch, K2/K7 and K1/K6; K9 on the int8
    leg), and on f32 copies the first action's logits within
    BUCKET_LOGIT_TOL and at least TP_ACTION_SHARE of a greedy
    chain's actions equal to one process's."""
    from bdm_db1_tpu_torch.ops import cuda_build
    from bdm_db1_tpu_torch.parallel.mesh import shard_rule, shard_tensor
    from bdm_db1_tpu_torch.train.checkpoint import load_model

    cuda_build.build_libraries(SOURCES)      # once, before the ranks load
    kernels = _tp_kernels(old_rel_bwd)
    t0 = time.perf_counter()
    one = reference.get(seed)
    reference_s = time.perf_counter() - t0
    weights = one["weights.pt"]
    with np.load(one["batch.npz"]) as f:
        raw = {k: f[k] for k in f.files}
    work = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    try:
        ckpt_dir = os.path.join(work, "ckpt")

        # ---- the world: train, then serve (counted in each rank) ---------
        cache_dir = os.path.join(work, "rl")
        _register_eval_envs(seed, cache_dir)
        cfgs = {}
        # without the expert prompt: its 1,032-token prime sends 16 GB of
        # f32 partial sums through gloo on the one card (the CPU tests
        # serve the prompt under tensor parallelism)
        for leg, over in (("bf16", {}),
                          ("int8", dict(decode_cache_dtype="int8",
                                        decode_weight_dtype="int8"))):
            c = _eval_cfg(cache_dir, ckpt_dir, os.path.join(work, "out_" + leg))
            c.model = dataclasses.replace(c.model, **over)
            c.eval = dataclasses.replace(c.eval, sharded_decode=True,
                                         decode_obs_buckets=True,
                                         max_step_size=TP_SERVE_STEPS,
                                         use_prompt=False)
            c.mesh = dataclasses.replace(c.mesh, model_parallel=TP_WORLD)
            cfgs[leg] = c
        primes = _tp_prime_stream(seed + 1, cfgs["bf16"].vocab.layout())
        t0 = time.perf_counter()
        both = _run_world("_tp_rank", work, one, ckpt_dir, cfgs, primes,
                          seed)
        world_s = time.perf_counter() - t0
        ranks = [r["train"] for r in both]
        evals = [r["serve"] for r in both]
        want = dict.fromkeys(ranks[0]["launches"], 0)
        for name in ("flash_rel_attention", "flash_rel_attention_bwd_dq",
                     "flash_rel_attention_bwd_dkv"):
            want[name] = 24 * len(raw["label"])
        layers = ranks[0]["layers"]
        if not (all(r["launches"] == want == r["launches_dropout_step"]
                    for r in ranks)
                and [r["coords"] for r in ranks] == [[0, 0], [0, 1]]
                and ranks[0]["loss"] == ranks[1]["loss"]
                and all(r["replicated_bitwise_equal_across_ranks"]
                        and r["replicated_params"] > 100 for r in ranks)
                and _tp_layers_ok(layers)):
            raise AssertionError(f"tensor-parallel ranks: "
                                 f"{[{k: v for k, v in r.items() if k != 'param_bits'} for r in ranks]}")

        # ---- the tp checkpoint, restored in one process ------------------
        cfg = _tp_cfg("bfloat16")
        model = _tp_model(cfg, None, weights)
        t0 = time.perf_counter()
        load_model(model, os.path.join(ckpt_dir, "1"))
        restore_s = time.perf_counter() - t0
        bad = []
        for n, p in model.named_parameters():
            rule = shard_rule(n, cfg.model)
            for r in ranks:
                part = p.detach() if rule is None else shard_tensor(
                    p.detach(), *rule, r["coords"][1], TP_WORLD)
                if int(part.view(torch.int32).sum(
                        dtype=torch.int64)) != r["param_bits"][n]:
                    bad.append((n, r["rank"]))
        del model
        gc.collect()
        torch.cuda.empty_cache()
        ref = ranks[0]["ref"]
        f32 = ref["f32"]
        loss_diff = abs(f32["loss_tp"] - f32["loss_one_process"])
        agree = f32["update"]
        train = {
            "gated_f32": dict(f32, loss_abs_diff=loss_diff,
                              loss_tol=DP_LOSS_TOL,
                              update_tol={"cosine_min": TP_F32_UPDATE_COS_MIN,
                                          "norm_rtol":
                                          TP_F32_UPDATE_NORM_RTOL}),
            "bf16": ref["bf16"],
            "bf16_update_tol": {"cosine_min": TP_BF16_UPDATE_COS_MIN,
                                "norm_rtol": TP_BF16_UPDATE_NORM_RTOL},
            "layers_bf16": layers,
            "layer_tol": {"out": ATTN_REL_TOL, "dx": GRAD_REL_TOL,
                          "grad_cosine_min": GRAD_COS_MIN,
                          "grad_norm_rtol": GRAD_NORM_RTOL},
            "checkpoint_restore_one_process_s": restore_s}
        agree16 = ref["bf16"]["update"]
        if bad or not (loss_diff <= DP_LOSS_TOL
                       and agree["update_cosine"] >= TP_F32_UPDATE_COS_MIN
                       and agree["update_norm_rel_diff"]
                       <= TP_F32_UPDATE_NORM_RTOL
                       and agree16["update_cosine"] >= TP_BF16_UPDATE_COS_MIN
                       and agree16["update_norm_rel_diff"]
                       <= TP_BF16_UPDATE_NORM_RTOL):
            raise AssertionError(f"tp step against the one-process step: "
                                 f"{train}, checkpoint slices {bad[:4]}")

        chk = evals[0]["checks"]
        serve = {"checks": chk, "layer_tol": ATTN_REL_TOL,
                 "f32_logit_tol": BUCKET_LOGIT_TOL,
                 "checks_s": evals[0]["checks_s"]}
        layers = chk["bfloat16"]["layers"] + chk["int8"]["layers"]
        if not (len(layers) == 2 * len(TP_RING_WIDTHS) * len(TP_LAYERS)
                and all(x["rel_diff"] <= ATTN_REL_TOL for x in layers)
                and chk["float32"]["logits_rel_diff"] <= BUCKET_LOGIT_TOL
                and chk["float32"]["actions_equal_share"]
                >= TP_ACTION_SHARE):
            raise AssertionError(f"sharded serve against one process: {chk}")
        for leg, c in cfgs.items():
            with open(os.path.join(c.train.save_dir, "results.output")) as f:
                lines = f.read().splitlines()
            recs = evals[0][leg]["records"]
            ok = (all(e[leg]["records"] == recs for e in evals)
                  and lines == [json.dumps(r) for r in recs]
                  and [r["env"] for r in recs] == list(EVAL_ENVS)
                  and all(np.isfinite(r["return_mean"])
                          and r["num_trials"] == EVAL_TRIALS for r in recs)
                  and all(_tp_plan_ok(e[leg], leg == "int8") for e in evals))
            if leg == "bf16":
                ok = ok and all(
                    e[leg]["launches"]["flash_ring_decode"]
                    == 24 * 5 * TP_SERVE_STEPS
                    and e[leg]["launches"]["flash_ring_prime_ap"]
                    == 24 * TP_SERVE_STEPS for e in evals)
            serve[leg] = {
                "ranks": [{k: e[leg][k] for k in ("launches", "wall_s",
                                                   "forwards")}
                          for e in evals],
                "actions_per_sec": TP_SERVE_B * TP_SERVE_STEPS / max(
                    e[leg]["wall_s"] for e in evals),
                "records": recs}
            if not ok:
                raise AssertionError(f"sharded serve ({leg}): {serve[leg]}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    launches = dict.fromkeys(want, 0)
    for r in ranks:
        for k in launches:
            launches[k] += r["launches"][k] + r["launches_dropout_step"][k]
    for e in evals:
        for leg in cfgs:
            for k in launches:
                launches[k] += e[leg]["launches"][k]
    return {"phase": "tensor_parallel", "config": "db1_1p2b", "card": smi,
            "world": TP_WORLD, "mesh": "(data 1, model 2)",
            "backend": "gloo, the ranks on cuda:0", "dtype": "bfloat16",
            "param_dtype": "float32", "optimizer": DP_OPT,
            "micro_batch": TP_MICRO, "accum": len(raw["label"]),
            "seq_length": raw["label"].shape[-1], "kernels_h8": kernels,
            "ranks": [{k: v for k, v in r.items() if k != "param_bits"}
                      for r in ranks],
            "world_s": world_s, "reference_s": reference_s, "train": train,
            "serve": serve, "serve_envs": TP_SERVE_B,
            "serve_steps": TP_SERVE_STEPS,
            "launches": launches}


PP_WORLD = 2
PP_MICRO = 2                   # pipeline micro-batches: one row x 1024 each
PP_LAYERS = 24 // PP_WORLD     # db1_1p2b's layers on a stage
# The bf16 pp step's update against the one-process bf16 step's, whole
# and in two groups: the stages' layers and the replicated parameters
# (the tied table, r_w_bias/r_r_bias, the vision tower). Both steps run
# the same bf16 kernels on the same rows; only the order of the
# gradients' sums differs (one micro-batch of one row at a time here).
# Sound readings (H100): cosine 0.99986 whole, 0.99987 the layers,
# 0.99981 the replicated, norms 7e-4 to 1.6e-3 apart. The tied table's
# gradient left unsummed over the stages read 0.99960 whole (TP's 0.9
# let it pass) and 0.99780 the replicated: the limit sits between, five
# times the sound gap and half the fault's.
PP_BF16_UPDATE_COS_MIN = 0.999
PP_BF16_UPDATE_NORM_RTOL = 1e-2
PP_UPDATE_GROUPS = ("layers", "replicated")
PP_NOTE = ("the step of one stage while the other shares the card; gloo "
           "sends each activation and its gradient, and sums the replicated "
           "parameters' gradients, through host memory: not a pipeline rate")


class _P2PLog:
    """Records the pipeline's sends and receives (parallel/pipeline.py
    ``send``/``recv``) while on, keeping copies of the tensors sent in
    ``keep`` when given, and replays them alone on zeros, in the same
    order."""

    def __init__(self, keep: list = None):
        from bdm_db1_tpu_torch.parallel import pipeline

        self.mod = pipeline
        self.keep = keep
        self.calls = []

    def __enter__(self):
        self.send, self.recv = self.mod.send, self.mod.recv

        def send(t, dst):
            self.calls.append(("send", tuple(t.shape), t.dtype, dst))
            if self.keep is not None:
                self.keep.append(t.detach().clone())
            return self.send(t, dst)

        def recv(shape, dtype, device, src):
            self.calls.append(("recv", tuple(shape), dtype, src))
            return self.recv(shape, dtype, device, src)

        self.mod.send, self.mod.recv = send, recv
        return self

    def __exit__(self, *exc):
        self.mod.send, self.mod.recv = self.send, self.recv

    def replay_ms(self) -> float:
        import torch.distributed as dist

        bufs = [(op, torch.zeros(shape, dtype=dtype, device="cuda"), peer)
                for op, shape, dtype, peer in self.calls]
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        for op, t, peer in bufs:
            if op == "send":
                self.send(t, peer)
            else:
                self.recv(t.shape, t.dtype, t.device, peer)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3


def _pp_rank(rank: int, world: int, ref: dict, ckpt_dir: str) -> dict:
    """One stage of the pp 2 world (dp 1, tp 1): its layers and the
    replicated parameters of the weights of ``ref``
    (``OneProcessReference``), in the pipeline's 2 micro-batches of one
    row. The f32 step (no dropout, SGD lr 1 without the clip) and its
    collective save as step 1 (the phase reads its update from it); the
    weights again and the bf16 step, counted and timed, its sends and
    receives and its collectives recorded and replayed alone: stage 0's
    sent activations against ``ref``'s rows, and the update's sums over
    this stage's layers and (stage 0) over the replicated parameters
    against the one-process bf16 update; a second step with the default dropout
    rates from the stage's generator, and the replicated parameters' bits
    exchanged."""
    import torch.distributed as dist

    from bdm_db1_tpu_torch.core.config import MeshConfig, db1_1p2b
    from bdm_db1_tpu_torch.models.transformer_xl import TransformerXL
    from bdm_db1_tpu_torch.parallel import pipeline
    from bdm_db1_tpu_torch.parallel.distributed import COLLECTIVES
    from bdm_db1_tpu_torch.parallel.mesh import (
        make_mesh, pipe_replicated, pipeline_parallel,
    )
    from bdm_db1_tpu_torch.train.checkpoint import CheckpointManager
    from bdm_db1_tpu_torch.train.convert import load_into
    from bdm_db1_tpu_torch.train.step import (
        init_train_state, make_train_rng, make_train_step,
    )
    from bdm_db1_tpu_torch.train.trainer import to_gato_batch

    stages, t0 = {}, time.perf_counter()
    cfg = _tp_cfg("float32")
    pp = pipeline_parallel(make_mesh(MeshConfig(pipeline_parallel=world),
                                     "cuda"), PP_MICRO)
    model = TransformerXL(cfg.model, cfg.vocab, device="cuda", pp=pp)
    weights = torch.load(ref["weights.pt"], map_location="cpu", mmap=True)
    load_into(model, weights)
    with np.load(ref["batch.npz"]) as f:
        batch = to_gato_batch({"rl": {k: f[k] for k in f.files}}, "cuda")
    stages["load_s"] = time.perf_counter() - t0
    # ---- the f32 step, saved ---------------------------------------------
    t0 = time.perf_counter()
    state = init_train_state(model, cfg.train.optimizer, 1)
    state, met = make_train_step(model)(
        state, batch, torch.Generator(device="cuda").manual_seed(0))
    loss32 = float(met["loss"])
    CheckpointManager(ckpt_dir).save(1, state)
    bits32 = _param_bits(model)
    stages["f32_step_and_save_s"] = time.perf_counter() - t0
    # ---- the bf16 step from the weights ----------------------------------
    load_into(model, weights)
    _set_dtype(model, "bfloat16")
    state = init_train_state(model, cfg.train.optimizer,
                             cfg.train.train_iters)
    step = make_train_step(model)
    gen = torch.Generator(device="cuda").manual_seed(0)
    sent = []
    p2p = _P2PLog(sent if pp.first else None)
    log = _CollectiveLog()
    torch.cuda.synchronize()
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    # ---- the main path, counted ------------------------------------------
    _reset_launches()
    for counts in (COLLECTIVES, pipeline.P2P):
        for k in counts:
            counts[k] = 0
    with log, p2p:
        t0 = time.perf_counter()
        state, met = step(state, batch, gen)
        loss = float(met["loss"])
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
    launches = _read_launches()
    # ----------------------------------------------------------------------
    p2p_counts, collectives = dict(pipeline.P2P), dict(COLLECTIVES)
    peak = torch.cuda.max_memory_allocated()
    p2p_ms = p2p.replay_ms()
    alone_ms = log.replay_ms()
    log.calls.clear()
    sent_rel_diff = None
    if pp.first:
        rows = torch.load(ref["stage_rows.pt"])
        sent_rel_diff = max(
            float((g.cpu().float() - w.float()).abs().max()
                  / w.float().abs().max()) for g, w in zip(sent, rows))
    t0 = time.perf_counter()
    one_after = torch.load(ref["bf16_after.pt"], map_location="cpu",
                           mmap=True)
    named = dict(model.named_parameters())
    update_sums = {"layers": _delta_sums(
        {n: p for n, p in named.items() if not pipe_replicated(n)},
        one_after, weights), "replicated": _delta_sums(
        {n: p for n, p in named.items() if pipe_replicated(n)
         and pp.first}, one_after, weights)}
    del one_after
    stages["update_sums_s"] = time.perf_counter() - t0
    # ---- the second step, with dropout (counted too) ---------------------
    base = db1_1p2b().model
    for name in ("drop", "embd_pdrop", "dropattn"):
        setattr(model.cfg, name, getattr(base, name))
    _reset_launches()
    state, met = step(state, batch, make_train_rng(0, "cuda", 0, pp.stage))
    loss2 = float(met["loss"])
    torch.cuda.synchronize()
    launches2 = _read_launches()
    # ----------------------------------------------------------------------
    mine = {n: b for n, b in _param_bits(model).items() if pipe_replicated(n)}
    every = [None] * world
    dist.all_gather_object(every, mine)
    return {"rank": rank, "stage": pp.stage,
            "layers": [pp.layers(cfg.model.n_layer).start,
                       pp.layers(cfg.model.n_layer).stop],
            "loss_f32": loss32, "loss": loss, "loss_dropout_step": loss2,
            "launches": launches, "launches_dropout_step": launches2,
            "p2p": p2p_counts, "collectives": collectives,
            "step_ms": step_ms, "step_ms_is": PP_NOTE,
            "p2p_alone_ms": p2p_ms, "p2p_share": p2p_ms / step_ms,
            "collectives_alone_ms": alone_ms,
            "gloo_share": (p2p_ms + alone_ms) / step_ms,
            "max_memory_allocated_gb": peak / 1e9,
            "sent_rel_diff": sent_rel_diff, "update_sums": update_sums,
            "param_bits_f32": bits32,
            "replicated_bitwise_equal_across_ranks": all(
                e == mine for e in every),
            "replicated_params": len(mine), "stages_s": stages}


def _pp_kernels(old_rel_bwd=None) -> dict:
    """K3 and the backward (K4, K5) at a pipeline micro-batch, one row x
    1024 with db1_1p2b's 16 heads, held to their plain versions and
    timed."""
    from bdm_db1_tpu_torch.ops import flash_rel_attention as fra

    shape = dict(B=TP_MICRO // PP_MICRO, qlen=1024, klen=1024, mem_len=1024,
                 same_length=True, timed=True)
    out = {"flash_rel_attention": _rel_case(fra, seed=107, **shape),
           "flash_rel_attention_bwd": _rel_bwd_case(fra, seed=108,
                                                    old=old_rel_bwd, **shape)}
    torch.cuda.empty_cache()
    return out


def phase_pipeline(smi: str, reference: "OneProcessReference",
                   seed: int = 0, old_rel_bwd=None) -> dict:
    """The GPipe pipeline in a world of two processes on the one card
    (gloo; NCCL refuses two ranks on one device), pp 2, dp 1, tp 1,
    db1_1p2b at full width and depth, 12 layers a stage, from the weights
    of ``reference`` on its 2-row micro-batch split into PP_MICRO pipeline
    micro-batches. First K3, K4 and K5 at a pipeline micro-batch against
    their plain versions (``_pp_kernels``). Then ``_pp_rank`` on each
    stage, and here: each stage's launches K3 = K4 = K5 = PP_LAYERS x
    PP_MICRO in the counted bf16 step and in the dropout step; the f32
    loss within DP_LOSS_TOL of the one-process f32 step; the f32
    checkpoint restored in one process, its parameters the stages' bit for
    bit, and its update within TP_F32_UPDATE_COS_MIN and
    TP_F32_UPDATE_NORM_RTOL of the one-process f32 update; the bf16 update
    (the stages' sums), whole and over the layers and the replicated
    parameters each, within PP_BF16_UPDATE_COS_MIN and
    PP_BF16_UPDATE_NORM_RTOL of the one-process bf16 update, its loss
    read beside the one-process bf16 step's own distance from f32
    (TP_ACTION_SHARE's comment says why); stage 0's sent activations
    within ATTN_REL_TOL of the one-process layer 11 on the same rows; the
    replicated parameters bitwise equal on both stages after the dropout
    step."""
    from bdm_db1_tpu_torch.models.transformer_xl import TransformerXL
    from bdm_db1_tpu_torch.ops import cuda_build
    from bdm_db1_tpu_torch.train.checkpoint import load_model

    cuda_build.build_libraries(SOURCES)      # once, before the ranks load
    kernels = _pp_kernels(old_rel_bwd)
    t0 = time.perf_counter()
    one = reference.get(seed)
    reference_s = time.perf_counter() - t0
    work = tempfile.mkdtemp(prefix="chip_smoke_pp_")
    try:
        ckpt_dir = os.path.join(work, "ckpt")
        t0 = time.perf_counter()
        ranks = _run_world("_pp_rank", work, one, ckpt_dir, world=PP_WORLD)
        world_s = time.perf_counter() - t0
        want = dict.fromkeys(ranks[0]["launches"], 0)
        for name in ("flash_rel_attention", "flash_rel_attention_bwd_dq",
                     "flash_rel_attention_bwd_dkv"):
            want[name] = PP_LAYERS * PP_MICRO
        sent = ranks[0]["sent_rel_diff"]
        gates = {
            "launches": all(r["launches"] == want
                            == r["launches_dropout_step"] for r in ranks),
            "stages_hold_their_layers": [r["layers"] for r in ranks] == [
                [s * PP_LAYERS, (s + 1) * PP_LAYERS]
                for s in range(PP_WORLD)],
            "one_loss_on_every_stage": len({r["loss"] for r in ranks}) == 1,
            "sends_and_receives": all(
                r["p2p"] == {"send": PP_MICRO, "recv": PP_MICRO}
                for r in ranks),
            "replicated_bitwise_equal": all(
                r["replicated_bitwise_equal_across_ranks"]
                and r["replicated_params"] > 3 for r in ranks),
            "stage0_sent": sent is not None and sent <= ATTN_REL_TOL}

        # ---- the f32 step's checkpoint, restored in one process ----------
        cfg = _tp_cfg("float32")
        model = TransformerXL(cfg.model, cfg.vocab, device="cuda")
        t0 = time.perf_counter()
        load_model(model, os.path.join(ckpt_dir, "1"))
        restore_s = time.perf_counter() - t0
        bits = _param_bits(model)
        bad = [(n, r["rank"]) for r in ranks
               for n, b in r["param_bits_f32"].items() if bits[n] != b]
        bad += [n for n in bits
                if not any(n in r["param_bits_f32"] for r in ranks)]
        f32_update = _update_agreement(
            model, torch.load(one["f32_after.pt"], map_location="cpu",
                              mmap=True),
            torch.load(one["weights.pt"], map_location="cpu", mmap=True))
        del model
        gc.collect()
        torch.cuda.empty_cache()
        loss_diff = abs(ranks[0]["loss_f32"] - one["f32_loss"])
        sums = {g: [sum(r["update_sums"][g][i] for r in ranks)
                    for i in range(3)] for g in PP_UPDATE_GROUPS}
        bf16_update = {g: _agreement(v) for g, v in sums.items()}
        bf16_update["whole"] = _agreement(
            [sum(v[i] for v in sums.values()) for i in range(3)])
        train = {
            "gated_f32": {"loss_pp": ranks[0]["loss_f32"],
                          "loss_one_process": one["f32_loss"],
                          "loss_abs_diff": loss_diff, "loss_tol": DP_LOSS_TOL,
                          "update": f32_update,
                          "update_tol": {"cosine_min": TP_F32_UPDATE_COS_MIN,
                                         "norm_rtol":
                                         TP_F32_UPDATE_NORM_RTOL}},
            "bf16": {"loss_pp": ranks[0]["loss"],
                     "loss_one_process": one["bf16_loss"],
                     "loss_abs_diff": abs(ranks[0]["loss"]
                                          - one["bf16_loss"]),
                     "one_process_bf16_vs_f32_loss_abs_diff":
                     one["bf16_vs_f32_loss_abs_diff"],
                     "one_process_bf16_vs_f32_update":
                     one["bf16_vs_f32_update"],
                     "update": bf16_update},
            "bf16_update_tol": {"cosine_min": PP_BF16_UPDATE_COS_MIN,
                                "norm_rtol": PP_BF16_UPDATE_NORM_RTOL},
            "stage0_sent_rel_diff": sent, "sent_tol": ATTN_REL_TOL,
            "checkpoint_restore_one_process_s": restore_s}
        gates.update({
            "checkpoint_bits": not bad,
            "f32_loss": loss_diff <= DP_LOSS_TOL,
            "f32_update": (
                f32_update["update_cosine"] >= TP_F32_UPDATE_COS_MIN
                and f32_update["update_norm_rel_diff"]
                <= TP_F32_UPDATE_NORM_RTOL),
            "bf16_update": all(
                u["update_cosine"] >= PP_BF16_UPDATE_COS_MIN
                and u["update_norm_rel_diff"] <= PP_BF16_UPDATE_NORM_RTOL
                for u in bf16_update.values())})
        failed = [k for k, ok in gates.items() if not ok]
        if failed:
            raise AssertionError(
                f"pipeline gates failed: {failed}; {train}; checkpoint "
                f"{bad[:4]}; stages {[_pp_public(r) for r in ranks]}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    launches = dict.fromkeys(want, 0)
    for r in ranks:
        for k in launches:
            launches[k] += r["launches"][k] + r["launches_dropout_step"][k]
    with np.load(one["batch.npz"]) as f:
        seq = int(f["label"].shape[-1])
    return {"phase": "pipeline", "config": "db1_1p2b", "card": smi,
            "world": PP_WORLD, "mesh": "(data 1, pipe 2, model 1)",
            "backend": "gloo, the ranks on cuda:0", "dtype": "bfloat16",
            "param_dtype": "float32", "optimizer": DP_OPT,
            "micro_batch": one["micro_batch"],
            "pipeline_microbatches": PP_MICRO, "layers_a_stage": PP_LAYERS,
            "seq_length": seq, "kernels_b1": kernels,
            "ranks": [_pp_public(r) for r in ranks], "world_s": world_s,
            "reference_s": reference_s, "train": train, "gates": gates,
            "launches": launches}


def _pp_public(rank: dict) -> dict:
    """A stage's record without its parameter bits."""
    return {k: v for k, v in rank.items() if k != "param_bits_f32"}


TP_NCCL_WORLD = 4


def _tp_nccl_rank(rank: int, world: int, cfg, seed: int) -> dict:
    """One rank of the NCCL serve: ``evaluate_rl.main`` with
    ``eval.sharded_decode`` on cuda:<rank>, counted, its ring forwards
    recorded by width."""
    import collections

    from bdm_db1_tpu_torch.eval import evaluate_rl
    from bdm_db1_tpu_torch.models.transformer_xl import TransformerXL

    _register_eval_envs(seed)
    widths = []
    ring_forward = TransformerXL.ring_forward

    def counting(self, h, *a, **kw):
        widths.append(int(h.shape[1]))
        return ring_forward(self, h, *a, **kw)

    TransformerXL.ring_forward = counting
    try:
        _reset_launches()
        t0 = time.perf_counter()
        records = evaluate_rl.main(cfg, device=f"cuda:{rank}")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read_launches()
    finally:
        TransformerXL.ring_forward = ring_forward
    return {"rank": rank, "records": records, "launches": launches,
            "wall_s": wall, "forwards": dict(collections.Counter(widths)),
            "backend": torch.distributed.get_backend()}


def phase_tensor_parallel_nccl(smi: str, seed: int = 0) -> dict:
    """Not in the default run (it needs TP_NCCL_WORLD cards): the sharded
    serve over NCCL across the cards of one host, a process a card, tp 4
    (4 of db1_1p2b's 16 heads a rank): ``evaluate_rl.main`` with
    ``eval.sharded_decode`` on the evaluate_rl phase's 40 envs with the
    expert prompt, TP_SERVE_STEPS steps, bf16, random weights from
    ``eval.seed``. Checks each rank's launches against the plan of its
    ring forwards (K1 120 and K2 24 a step), the ranks' records equal and
    finite; reads the wall time and actions/sec."""
    from bdm_db1_tpu_torch.ops import cuda_build

    n = torch.cuda.device_count()
    if n < TP_NCCL_WORLD:
        raise SystemExit(f"tensor_parallel_nccl needs {TP_NCCL_WORLD} "
                         f"cards; {n} visible")
    cuda_build.build_libraries(SOURCES)
    work = tempfile.mkdtemp(prefix="chip_smoke_tp_nccl_")
    try:
        cache_dir = os.path.join(work, "rl")
        _register_eval_envs(seed, cache_dir)
        cfg = _eval_cfg(cache_dir, "", os.path.join(work, "out"))
        cfg.eval = dataclasses.replace(cfg.eval, sharded_decode=True,
                                       max_step_size=TP_SERVE_STEPS)
        cfg.mesh = dataclasses.replace(cfg.mesh,
                                       model_parallel=TP_NCCL_WORLD)
        t0 = time.perf_counter()
        ranks = _run_world("_tp_nccl_rank", work, cfg, seed,
                           world=TP_NCCL_WORLD, backend="nccl")
        world_s = time.perf_counter() - t0
        recs = ranks[0]["records"]
        ok = (all(r["records"][:len(EVAL_ENVS)] == recs[:len(EVAL_ENVS)]
                  for r in ranks)
              and all(np.isfinite(x["return_mean"])
                      and x["num_trials"] == EVAL_TRIALS for x in recs)
              and all(r["backend"] == "nccl" and _tp_plan_ok(r, False)
                      and r["launches"]["flash_ring_decode"]
                      == 24 * 5 * TP_SERVE_STEPS
                      and r["launches"]["flash_ring_prime_ap"]
                      == 24 * TP_SERVE_STEPS for r in ranks))
        out = {"phase": "tensor_parallel_nccl", "config": "db1_1p2b",
               "card": smi, "cards": n, "world": TP_NCCL_WORLD,
               "mesh": f"(data 1, model {TP_NCCL_WORLD})",
               "heads_a_rank": 16 // TP_NCCL_WORLD,
               "envs": TP_SERVE_B, "steps": TP_SERVE_STEPS,
               "ranks": [{k: r[k] for k in ("launches", "wall_s",
                                            "forwards")} for r in ranks],
               "actions_per_sec": TP_SERVE_B * TP_SERVE_STEPS / max(
                   r["wall_s"] for r in ranks),
               "world_s": world_s, "records": recs}
        if not ok:
            raise AssertionError(f"NCCL sharded serve: {out}")
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)


# what each time of the K4/K5 rows of the kernels line is
BWD_TIMES = {
    "ms": "the kernel alone: CUDA events around bare launches, on delta and "
          "the key terms made beforehand",
    "train_profile_ms": "the kernel alone: its device time in the train "
                        "profile over its launches there",
    "call_ms": "the whole flash_rel_attention_bwd call: the preparation "
               "(delta, key terms), K4, K5, the zeroed sums and allocations",
    "prep_ms": "the preparation kernel alone",
    "old_ms": "--old-rel-bwd: the old K5 alone on this tree's delta and key "
              "terms, in turns with ms (old, new, new, old)",
    "turns_ms": "--old-rel-bwd: the four turns (old, new, new, old)"}


# --old-ring (K1, K2, K6, K7, K8) and --old-rel-fwd (K3): the old kernel's
# mean of its two turns, and the four turns (new, old, old, new) in ms
RING_TURNS = ("old_ms", "turns_ms")


def _bwd_rows(bwd: dict) -> dict:
    """The backward's case as the kernels line's K4 and K5 entries: each
    its own time and bound, the plain backward's time (both kernels'
    work) and the SDPA backward (K4 + K5)."""
    return {"flash_rel_attention_bwd_" + which: dict(
        bwd, **bwd[which], max_abs_err=max(bwd["abs_err"][n] for n in grads))
        for which, grads in (("dq", ("dq",)),
                             ("dkv", ("dk", "dv", "drk", "drw", "drr")))}


def _tp_rows(tp: dict) -> dict:
    """The tensor_parallel phase's kernel cases (``_tp_kernels``) by the
    kernels line's names: K8 from the int8 prime's case, K4 and K5 each
    from the backward's, K9 at qkv_net's 40 rows with every TP shape
    under ``cases``."""
    out = dict(tp)
    k7 = tp["flash_ring_prime_ap_int8"]
    out["flash_ring_prime"] = dict(k7, ms=k7["k8_ms"],
                                   max_abs_err=k7["k8_max_abs_err"])
    out.update(_bwd_rows(out.pop("flash_rel_attention_bwd")))
    qmm = tp["quant_matmul"]
    out["quant_matmul"] = dict(qmm[0], cases=[
        {k: c[k] for k in ("shape", "ms", "bound_ms", "bound_by",
                           "library_ms", "plain_ms", "plan", "max_abs_err")}
        for c in qmm])
    return out


def kernels_line(kernels: dict, launches: dict, alone: dict,
                 tp: dict = None, pp: dict = None) -> dict:
    """One record per kernel: its numbers at the main path's shape (the
    first case of each; K9 at the serve's q == 1 rows and the largest trunk
    matrix, with every timed K9 shape under ``cases``) and its launches in
    the counted main-path runs of the same process. K8 is held by the
    kernels phase only: no main path runs it. ``alone``: the kernel-alone
    ms per launch in the train profile (``kernel_alone_ms``). ``tp``: the
    tensor_parallel phase's cases at a rank's shapes (H 8), on each row
    as ``tp2_h8``; ``pp``: the pipeline phase's at a pipeline micro-batch
    (B 1), on the K3, K4 and K5 rows as ``pp_b1``."""
    tp_rows = _tp_rows(tp) if tp else {}
    pp_rows = {}
    if pp:
        pp_rows = dict(pp)
        pp_rows.update(_bwd_rows(pp_rows.pop("flash_rel_attention_bwd")))
    cases = kernels["cases"]
    pick = {name: cases[name][0] for name in cases}
    pick["quant_matmul"] = next(
        c for c in cases["quant_matmul"]
        if c["shape"] == {"R": QMM_ROWS[0], "K": 2048, "N": 8192})
    k7 = {k: v for k, v in cases["flash_ring_prime_ap_int8"][0].items()
          if k not in RING_TURNS}
    pick["flash_ring_prime"] = dict(k7, ms=k7["k8_ms"],
                                    max_abs_err=k7["k8_max_abs_err"],
                                    **{t: k7["k8_" + t] for t in RING_TURNS
                                       if "k8_" + t in k7})
    pick.update(_bwd_rows(cases["flash_rel_attention_bwd"][0]))
    rows = []
    for name, replaces in K_REPLACES.items():
        case = pick[name]
        rows.append({
            "name": name, "route": "cuda", "source": K_SOURCES[name],
            "replaces": replaces, "launches": launches[name],
            "on_path": launches[name] > 0,
            "max_abs_err": case["max_abs_err"], "ms": case["ms"],
            "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
            "bound_by": case["bound_by"], "library_ms": case["library_ms"],
            "shape": case["shape"]})
        if name in alone:
            rows[-1]["train_profile_ms"] = alone[name]
        for key, extra in (("tp2_h8", tp_rows), ("pp_b1", pp_rows)):
            if name in extra:
                c = extra[name]
                rows[-1][key] = {k: c[k] for k in (
                    "shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms", "cases", "old_ms", "turns_ms")
                    if k in c}
        rows[-1].update({k: case[k] for k in RING_TURNS if k in case})
        if name.startswith("flash_rel_attention_bwd"):
            rows[-1].update({k: case[k] for k in BWD_TIMES if k in case})
            rows[-1]["times"] = {k: v for k, v in BWD_TIMES.items()
                                 if k in rows[-1]}
        if name == "quant_matmul":
            rows[-1]["cases"] = [
                {k: c[k] for k in ("shape", "ms", "bound_ms", "bound_by",
                                   "library_ms", "plain_ms", "old_ms")
                 if k in c}
                for c in cases[name] if "ms" in c]
    return {"kernels": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated, of " + ", ".join(
                        PHASES + OPTIONAL_PHASES))
    ap.add_argument("--old-qmm", default=None, metavar="SRC",
                    help="a copy of an earlier csrc/quant_matmul.cu: its K9 is "
                         "timed in turns with this tree's")
    ap.add_argument("--old-rel-bwd", default=None, metavar="SRC",
                    help="a copy of an earlier csrc/flash_rel_attention_bwd.cu"
                         " with this tree's C interface: its K5 is held to "
                         "this tree's and timed in turns with it at the four "
                         "timed K5 shapes")
    ap.add_argument("--old-ring", default=None, metavar="SRC",
                    help="a copy of an earlier csrc/flash_ring_decode.cu: its "
                         "decode (K1, K6) and prime (K2, K7, K8) are held to "
                         "this tree's and timed in turns with them")
    ap.add_argument("--probe", action="store_true",
                    help="record, without failing on them, how far the "
                         "--old-ring/--old-rel-fwd/--old-rel-bwd kernels' "
                         "outputs are from this tree's (probe builds with a "
                         "part taken out)")
    ap.add_argument("--old-rel-fwd", default=None, metavar="SRC",
                    help="a copy of an earlier csrc/flash_rel_attention.cu: "
                         "its K3 is held to this tree's and timed in turns "
                         "with it")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    unknown = set(phases) - set(PHASES + OPTIONAL_PHASES)
    if unknown:
        raise SystemExit(f"unknown phases {sorted(unknown)}")
    if "evaluate_rl" in phases and "train" not in phases:
        raise SystemExit("the evaluate_rl phase serves the train phase's "
                         "checkpoint: name train too")
    for phase in ("evaluate_rl_image", "evaluate_rl_text"):
        if phase in phases and "pretrain_vision" not in phases:
            raise SystemExit(f"the {phase} phase serves the "
                             "pretrain_vision phase's checkpoint: name "
                             "pretrain_vision too")

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none is visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    results = {}
    old_bwd = (OldRelBwd(args.old_rel_bwd, not args.probe)
               if args.old_rel_bwd else None)
    if "build" in phases:
        results["build"] = phase_build()
        emit(results["build"])
    if "kernels" in phases:
        results["kernels"] = phase_kernels(args.old_qmm, old_bwd,
                                           args.old_ring, args.old_rel_fwd,
                                           args.probe)
        emit(results["kernels"])
    serves = {"serve": dict(batch=40),
              "serve_int8": dict(batch=56, decode_cache_dtype="int8",
                                 decode_weight_dtype="int8")}
    for phase, kw in serves.items():
        if phase in phases:
            gc.collect()
            torch.cuda.empty_cache()
            results[phase] = phase_serve(smi, phase=phase, **kw)
            emit(results[phase])
    if "serve_spec" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        results["serve_spec"] = phase_serve_spec(smi)
        emit(results["serve_spec"])
    # the train phase's checkpoint and a host copy of its weights, served
    # and checked by evaluate_rl; the directory is deleted at the end
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    saved_weights = {}
    try:
        for phase, fn, args in (
                ("eval_loss", phase_eval_loss, ()),
                ("train", phase_train, (ckpt_dir, saved_weights)),
                ("evaluate_rl", phase_evaluate_rl, (ckpt_dir, saved_weights))):
            if phase in phases:
                gc.collect()
                torch.cuda.empty_cache()
                results[phase] = fn(smi, *args)
                emit(results[phase])
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        saved_weights.clear()
    if "pretrain" in phases:
        # the train phase's model and optimizer state are garbage by now
        gc.collect()
        torch.cuda.empty_cache()
        results["pretrain"] = phase_pretrain(smi)
        emit(results["pretrain"])
    # the image mixture's data and checkpoint, and a host copy of its
    # weights, served by evaluate_rl_image; deleted at the end
    vis_dir = tempfile.mkdtemp(prefix="chip_smoke_vision_")
    saved_weights = {}
    try:
        for phase, fn in (("pretrain_vision", phase_pretrain_vision),
                          ("evaluate_rl_image", phase_evaluate_rl_image),
                          ("evaluate_rl_text", phase_evaluate_rl_text)):
            if phase in phases:
                gc.collect()
                torch.cuda.empty_cache()
                results[phase] = fn(smi, vis_dir, saved_weights)
                emit(results[phase])
    finally:
        shutil.rmtree(vis_dir, ignore_errors=True)
        saved_weights.clear()
    if "generate" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        results["generate"] = phase_generate(smi)
        emit(results["generate"])
    # the one-process steps that tensor_parallel and pipeline are held to,
    # made once; deleted at the end
    reference = OneProcessReference()
    try:
        for phase, fn in (
                ("stateless", phase_stateless),
                ("remat", phase_remat),
                ("serve_preln", phase_serve_preln),
                ("data_parallel", phase_data_parallel),
                ("tensor_parallel", functools.partial(
                    phase_tensor_parallel, reference=reference,
                    old_rel_bwd=old_bwd)),
                ("pipeline", functools.partial(
                    phase_pipeline, reference=reference,
                    old_rel_bwd=old_bwd)),
                ("tensor_parallel_nccl", phase_tensor_parallel_nccl)):
            if phase in phases:
                gc.collect()
                torch.cuda.empty_cache()
                results[phase] = fn(smi)
                emit(results[phase])
    finally:
        reference.close()

    print(smi, flush=True)
    # launches are counted only on the main paths (both serves, the
    # validation loss and training): without them this run has no count
    if "kernels" in results and all(p in results for p in MAIN_PATHS):
        launches = {name: sum(results[p]["launches"][name]
                              for p in MAIN_PATHS)
                    for name in K_REPLACES}
        emit(kernels_line(results["kernels"], launches,
                          results["train"]["kernel_alone_ms"],
                          results["tensor_parallel"]["kernels_h8"],
                          results["pipeline"]["kernels_b1"]))
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
