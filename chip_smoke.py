#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

Drives the port's main paths through the entry points a user calls:
partition and serve the ``qwen2_05b`` prefill step with its fused
attention sites on the hand-written CUDA flash-attention kernel, on the
card and on a two-device mesh of two ranks sharing it, and the
``recurrentgemma_2b`` hybrid prefill step with its RG-LRU scan sites on
the hand-written CUDA RG-LRU kernel (its TMA-ring route; the generic
route takes strides TMA cannot describe); for both models the decode
step with its KV and recurrent caches, planned with the serving launcher's
request (the KV cache pinned replicated) and served token by token; for
both models the train step, through each kernel's autograd, captured with
its state donated; and the training launcher, with checkpoints, a failure
and a restart, on one card and on two ranks sharing it, and the serving
launcher on those two ranks; and the mixture-of-experts models
``mixtral_8x22b`` and ``arctic_480b`` at full width (cut in depth to what
the card holds, their plans searched at full depth), prefill and decode,
arctic's attention sites on the CUDA flash-attention kernel, on one card
and on two ranks sharing it; ``mixtral_8x22b``'s train step at full
width on one card and on two ranks sharing it; ``xlstm_350m`` at
full width and depth, prefill and decode, its mLSTM and sLSTM blocks on
no kernel (the sLSTM's time scan nested in the layer scan); and the
frontend models at full width and depth, ``whisper_small`` (its
encoder's attention on the kernel non-causal, its decoder's causal, the
decoder's cross-attention on the einsum path) and ``phi3_vision`` (its
patch embeddings before the tokens, the kernel at head dim 96), prefill
and decode, their training, and all three on two ranks sharing the
card; and the search around the core: the portfolio search, the mesh
co-search and the plan store, a stored plan served on the card.

1. print the card's name and power limit; build both kernels from the
   sources in this checkout, in parallel;
2. hold each kernel against its plain PyTorch version on the card, at
   its slice shape and at edge shapes (attention: every head dim it is
   built for, in both dtypes; RG-LRU: each case checks which route it
   took);
3. trace and analyze both full-width prefill steps on ``meta`` tensors
   (``Session``, in the worker process); the mesh phase: search each
   step's plan for a (data 1, model 2) mesh, hand it as JSON to two
   ranks (processes of one gloo group, CUDA tensors, both on card 0),
   which make the same seeded
   weights, apply the plan eagerly over a ``DeviceMesh`` and answer 2
   requests per model, their kernel sites on local shards under
   ``local_map``; print each plan's in-spec summary and sharded sites,
   each rank's kernel launches (counted from zero for the requests),
   local kernel shapes and strides, RG-LRU routes, copies and reshapes
   made whole, the collectives by kind (``CommDebugMode``) and bytes,
   and the per-request ms of the two ranks time-sharing the card (not a
   multi-card figure); the gathered last-token logits are held against
   the one-card captured plan's of step 4 on the same requests;
   for each path: search a plan for an 8-card node (2x4 mesh) on the
   host and check its JSON round trip; search the one-card plan, check
   every kernel site chose ``"cuda"``, and apply it on the card with
   seeded random weights;
4. answer 3 requests per path (qwen2_05b: 4 prompts x 2048 tokens;
   recurrentgemma_2b: 4 x 4096, twice its local window) through the
   applied plan, which captures the step as one CUDA graph on its first
   call and replays it, and again through the same plan applied eagerly
   (``capture=False``): the logits must be equal bit for bit; count each
   kernel's launches from zero (each replay counted as the launches its
   capture recorded; RG-LRU: by route, all on the TMA ring); time both in
   turns; hold the last-token logits against the same requests with
   every site forced to the plain version; check a small f32 model
   against the plain path too;
5. for each model's decode path (``launch/serve.py``, the same weights,
   cut to ``DECODE_DEPTH``: 4 of ``qwen2_05b``'s 24 layers, 8 of
   ``recurrentgemma_2b``'s 26):
   trace and analyze the decode step at B = 4 and cache 256; search the
   2x4 plan with the serving launcher's request (it must satisfy its
   ``Replicate`` constraints and round-trip through JSON) and the 1x1
   plan (no kernel sites), and apply the latter on the card, captured
   (one graph for every step) and eager; answer 3 requests of 4 prompts
   x 128 tokens, each prefilled token by token through the decode step
   and then decoded greedily for 128 tokens, with no kernel launched,
   captured and eager in turns: the tokens, the prompt logits and the
   final cache must be equal bit for bit; hold the logits after the last
   prompt token against the prefill step's (its 1x1 plan captured, sites
   on the CUDA kernels) on the same prompts; print per-token times of
   both beside the step's weight-read bound, each graph's capture
   seconds and pool bytes; release every graph; check a small f32
   model's decode logits at every position against its forward through
   the kernels (the hybrid's local ring wraps);
6. for the ``qwen2_05b`` train path (after its prefill and decode):
   trace and analyze the full-width train step (AdamW, the loss's
   gradient through the attention kernel's autograd, remat) on ``meta``
   tensors at the prefill path's shape; search the 2x4 plan (JSON round
   trip) and the 1x1 plan; take step 1 with every site on the plain
   version; then 8 steps through the kernels on one fixed batch from the
   seed, first captured with the train state donated
   (``plan.apply(step, donate_argnums=0)``: one CUDA graph that writes
   each new state into the old one's buffers) and then eagerly from the
   same state, each step timed, with its peak memory, its kernel
   launches (24 forward and 24 recomputed under remat; a replay counted
   as the launches its capture recorded) and plain-vjp backward sites;
   every loss and grad norm and the final state (kept on the host) must
   be equal captured and eager, bit for bit, or within two eager runs'
   spread; the loss must stay finite and fall; hold step 1 through the
   kernels against step 1 on the plain version (loss and grad norm), and
   a small f32 model's loss, gradients and updated state likewise;
6b. the training launcher (``launch/train.py``) on ``qwen2_05b`` at the
   same shape, cut to 4 of its 24 layers: 6 steps from the seed's
   weights and data pipeline uninterrupted (``--plan manual``), then
   again with ``--plan toast``, a checkpoint every 3 steps and a failure
   injected at step 4: attempt 1 must resume from
   step 3, each attempt capture one graph, and the final checkpoint
   equal the uninterrupted run's final state bit for bit; the seconds
   and bytes of each save and restore are printed;
6c. the mesh launcher phase: the one-card uninterrupted run's final
   state moved to the host, two ranks of one gloo group share card 0
   and run ``launch/train.py`` at the same width, depth and schedule with
   ``--plan toast`` on the (data 1, model 2) mesh (the reference's rules
   route: the state placed by the plan's logical rules, the step eager
   on DTensors, every attention site on whole q, k, v): per rank the
   rules, the state's and peak bytes, each step's ms, the collectives
   per step by kind and bytes, 48 attention launches a step and their
   local shapes, each save's and the restore's seconds, the step the
   restart resumed from; the final checkpoint (written by rank 0 from
   the shards) must be step 6, every loss and grad norm within 2e-2 of
   the one-card run's, and every leaf within 2e-2 (relative, in norm)
   beyond the distance from that run of one card's run of the same
   batches in two microbatches (bf16 rounding that AdamW amplifies in a
   leaf whose gradient cancels); then
   both models, each at its ``DECODE_DEPTH``, serve one request of 4 x
   (16 prompt + 16 generated) tokens through ``launch/serve.py`` on the
   same ranks (the decode
   step's plan for (1, 2), the weights and cache replicated), the prompt
   logits within 2e-2 of the largest and argmax equal to one card's
   serve of the same prompts;
7. the same as 6 for the ``recurrentgemma_2b`` train path (after its
   prefill and decode, the ``qwen2_05b`` train states freed): the
   full-width step at B 1 x S 4096 with bf16 moments, whose RG-LRU sites
   launch the kernel 18 times forward (8 periods of 2 and the tail's 2)
   and 16 times recomputed, all on the TMA ring, with 18 plain-vjp
   backwards; its small f32 model has two periods and the tail (8
   layers);
7b. the MoE models, ``mixtral_8x22b`` and then ``arctic_480b``, each
   at full width with random bf16 weights from the seed, cut to 2 and 1
   layers (each freed before the next): search the
   2x4 plans of the full-depth prefill and decode steps on ``meta``
   tensors (time to a plan, colors, conflicts, the expert weights'
   specs); apply the 1x1 plans of the cut model's own prefill and
   decode steps, traced and searched on ``meta`` tensors too (arctic's attention sites on the CUDA kernel, mixtral's windowed
   attention on the einsum path); answer 3 requests of 4 x 2048 tokens
   captured and eager in turns, the logits equal bit for bit, each
   request's ms, peak and reserved GB and the graph pool; print the
   routed tokens each request's rows dropped to capacity per layer; hold
   arctic's attention sites at the model's own q, k, v against the plain
   attention (2e-2, bf16) and its last-token logits against the plain
   sites' (2e-2 of the largest logit), printing per layer how many
   capacity selections the two runs made differently; then the decode
   path as in 5, holding decode's logits after the prompt against
   prefill's only for rows whose prefill dropped no routed token;
7c. the MoE models on two ranks of one gloo group sharing card 0, each
   cut to what two ranks holding its weights fit (``mixtral_8x22b`` 2
   layers, ``arctic_480b`` 1): the cut prefill step's (1, 2) plan and the
   serving launcher's decode plan for two devices searched on ``meta``
   tensors in the worker process (the plan's expert-weight specs and
   conflicts printed); one card first answers 2 requests of 4 x 2048
   through the 1x1 plan and serves one request of 4 x (16 prompt + 16
   generated) tokens through ``serve_loop``; then the ranks answer the
   same requests through ``plan.apply`` of the (1, 2) plan (weights
   placed leaf by leaf) and serve the same request through the
   launcher's route (``serve.serve_replicated``: weights, cache and
   prompts replicated, the decode plan's rules); per rank the
   collectives by kind and bytes, ms per request and per token, peak GB,
   arctic's attention launches and local shapes; the gathered logits
   within 2e-2 of the largest of one card's, the capacity selections
   that differ counted per layer, the served prompt logits within 2e-2
   and their argmax equal but in a row whose one-card top two logits
   lie within twice the largest difference (a tie, printed with its
   margin), and no expert stack gathered whole;
7d. MoE training: ``mixtral_8x22b`` at full width cut to 1 layer (what
   one card holds with gradients, moments and the step's temporaries),
   B 1 x S 4096, AdamW with bf16 moments, remat: search the 2x4 plan of
   the full-depth (56-layer) train step on ``meta`` tensors in the
   worker process (time to the plan, colors, conflicts, the expert and
   router weights' specs) and the cut step's 1x1 plan (no kernel site:
   the windowed attention takes the einsum path); step 1 forward and
   backward with the weights in f32 (no AdamW); then 8 steps captured
   with the state donated and 8 eager, as in 6: the losses, grad norms
   and final state equal bit for bit, the loss falling, step 1's loss
   and grad norm within 2e-2 of the f32 step's; per eager step and layer
   the routed pairs dropped to capacity and the router picks and expert
   tokens remat's recomputation chose otherwise than the forward (none,
   or it fails); step ms, peak, pool and reserved GB, launches per step;
7e. MoE training on two ranks of one gloo group sharing card 0 (after
   7d, its states freed): ``mixtral_8x22b`` at full width cut to 1
   layer, B 1 x S 2048, AdamW with bf16 moments at 1e-4, remat: search
   the cut train step's (1, 2) plan on ``meta`` tensors in the worker
   process with a ``HardwareSpec`` whose ``hbm_per_chip`` is each rank's
   share of the card (its conflicts, predicted peak, the tokens' and
   the expert and router weights' specs); one card first takes 4 eager
   steps from the seeded state on one fixed batch (the final state kept
   on the host), the same steps with each product the plan splits
   between the ranks taken as its two halves' sum (the regrouping
   floor: each leaf's distance from the first run, and the router's
   after step 1), and the same steps with the router's gradient scaled
   by 0.9 (a planted fault: some leaf must land beyond its limit); then
   each rank makes the seeded weights, places them leaf by leaf (the
   moments as zeros in the plan's placements) and takes the 4 steps
   through ``plan.apply(step, donate_argnums=0)``, each timed, its
   collectives by kind and result bytes, the routed pairs dropped and
   the router picks and expert tokens remat's recomputation chose
   otherwise on the rank's shards (none, or it fails); every loss and
   grad norm within 2e-2 of one card's, every leaf of the final state
   (made whole on the host from the ranks' blocks) and the router's
   after step 1 within its floor + 2e-2, the loss falling, no expert
   stack, gradient or moment gathered whole; per rank the step ms (two
   ranks time-sharing the card: not a multi-card figure), peak and
   reserved GB;
7f. xLSTM (run right after 2, while the workers search the first two
   prefill steps' plans): ``xlstm_350m`` at full width and full depth (24
   layers, 210.2 M parameters, bf16 from the seed): its prefill step's
   2x4 and 1x1 plans searched on ``meta`` tensors in the worker process
   (the sLSTM's time scan traced inside the layer scan's body: trip
   counts 3 and 3 x 2048); 3 requests of 4 x 2048 tokens through the
   1x1 plan captured and eager in turns, the logits finite and equal bit
   for bit, no kernel launched; each request's ms, peak and reserved
   GB, the capture's seconds and pool; one sLSTM and one mLSTM block at
   the prefill's shape captured alone, each graph's nodes (its launches)
   and replay ms, and their share of a captured request; then the decode
   path as in 5, cut to its first 8 layers (one period); then the
   16-layer reduced f32 model (two sLSTMs): its decode against its
   forward (in 5's small check) and its forward on the card against the
   same model on the CPU, within 1e-4;
7g. the frontend models (after 7e), each at full width and full depth
   with bf16 weights from the seed, one after the other:
   ``whisper_small`` (12 encoder + 12 decoder layers, 0.28 B parameters)
   and ``phi3_vision`` (32 layers, head dim 96, 3.8 B): the prefill
   step's 2x4 and 1x1 plans searched on ``meta`` tensors in the worker
   process (their kernel sites: whisper's encoder site non-causal, its
   decoder's causal); the prefill path as in 4, its 3 requests
   whisper's of 4 x (1500 frames + 1500 tokens), phi3_vision's of 4 x
   (576 patch embeddings + 1472 tokens), the attention launches counted
   per request (24: 12 non-causal and 12 causal; 32); every site held at
   its own q, k, v against the plain attention (2e-2, bf16), whisper's
   encoder output within 2e-2 of the largest through the plain sites;
   then the decode path as in 5, cut to ``DECODE_DEPTH`` (whisper's
   first 4 decoder layers since PR 29, against the full encoder's
   output of 1500 frames, which every step's cross-attention
   reads and projects anew: its bound counts those reads and the
   projections' operations; phi3_vision's first 8 layers since PR 29,
   text only), its small f32
   model's decode against its forward; for whisper, the serving
   launcher's command line once on the card;
7h. training the xLSTM and the frontend models (after 7g), one after
   the other, each at full width with bf16 weights from the seed:
   ``whisper_small`` at full depth, B 4 x (1500 frames + 1500 tokens);
   ``phi3_vision`` cut to 8 of its 32 layers (its full-depth state, ~46
   GB, and the captured step's second copy do not fit the card), B 4 x
   (576 patches + 1472 tokens); ``xlstm_350m`` cut to one period of 8
   layers (7 mLSTM + 1 sLSTM: the time scan nested in the layer scan's
   forward and backward bodies), B 4 x 2048, without remat (its small
   model trains with remat); each train step traced and
   its 2x4 and 1x1 plans searched in the worker process, phi3_vision's
   and the xLSTM's full-depth train plans too (reported); then the
   train path as in 6 (``drive_train``): ``TRAIN_STEPS`` steps through
   ``plan.apply(step, donate_argnums=0)`` captured and the same steps
   eagerly from the same state, equal bit for bit, the loss falling,
   step 1 on the kernel sites against the plain sites within
   ``TRAIN_REL_TOL``, the attention launches a step equal to the
   forward sites and remat's recomputation (48, 16, 0) and each step's
   ms, peak, pool and reserved GB; the small f32 model (whisper and
   phi3_vision reduced, the xLSTM at 16 layers, remat on) on the card
   against the same model on the CPU within ``SMALL_TOL``;
7i. the xLSTM and the frontend models on two ranks of one gloo group
   sharing card 0 (after 7h), each at full width cut in depth
   (``FAMILY_MESH``: ``xlstm_350m`` one period of 8 layers, in f32;
   ``whisper_small`` 1 encoder + 1 decoder layer; ``phi3_vision`` 1):
   each cut model's prefill and train steps planned for (1, 2) in the
   worker process with each rank's share of the card as
   ``hbm_per_chip``, with the serving launcher's decode plan for two
   devices (the specs of ``R``, the mLSTM projections, the encoder's
   weights and ``enc_out`` printed); one card first: the prefill
   request through the 1x1 plan (eager), one ``MESH_SERVE`` request
   through ``serve_loop`` (whisper's against its 16 seeded frames),
   ``FAMILY_MESH_STEPS`` eager train steps from the seeded state on one
   fixed batch and the same steps regrouped (the floor); then one group
   of two ranks for all three models: the request through ``plan.apply``
   of the (1, 2) plan, the served request through ``launch/serve.py``'s
   route (whisper's encoder output encoded on each rank before
   placement, replicated), the train steps through ``plan.apply(step,
   donate_argnums=0)`` of the (1, 2) train plan; per rank the ms per
   request, per token and per step (two ranks time-sharing the card:
   not a multi-card figure), collectives by kind and bytes, peak GB,
   the attention launches and their local shapes, each sLSTM loop's
   seconds, DTensor ops and collectives (one local region per layer,
   whatever its length); the gathered logits within 2e-2 of one card's
   largest, the served prompt logits too with argmax equal but in a
   printed tie, every loss and grad norm within 2e-2 of one card's,
   every leaf within its floor + 2e-2, the loss falling;
7j. the plan store (after 7i): two jobs, one after the other, each in a
   worker process of its own started beside the pool, trace the
   full-width ``qwen2_05b`` prefill step at the path shape on ``meta``
   tensors in a ``Session`` over one fresh store directory; the first
   co-searches every mesh of an 8-card node in one or two pods with the
   portfolio the reference's zoo driver uses (greedy, a beam of width 4,
   two MCTS seeds, two threads, early stopping) and partitions the 1x1
   request with it, each plan written to the store (a line per
   candidate: mesh, status, cost, feasibility, search seconds; the best
   mesh and the best multi-pod one); the second must find the same
   fingerprint, and every plan the first searched as a store hit
   (``cached``, no cost model built), equal to the one written; then
   the card applies the 1x1 plan the second read back (every site on
   ``"cuda"``), captured, to the first request of step 4 with the
   seed's weights: 24 attention launches, and last-token logits equal
   to step 4's captured plan's bit for bit; the seconds the card
   waited on the jobs and the phase's seconds are printed;
8. time each kernel at its slice shape beside its bound, its plain
   version and, for attention, ``scaled_dot_product_attention`` (a
   yardstick only: the port never calls it), and at ``arctic_480b``'s
   shape (4, 2048, 56, 128) and at the frontend models' shapes
   (whisper's (4, 1500, 12, 64) non-causal and causal, phi3_vision's (4,
   2048, 32, 96)); time the attention kernel
   and SDPA at head dims 96 and 128 too, at the slice's B, S and H, and
   at hd 64 without the causal mask and at four times the length; time
   the RG-LRU ring in bf16 and at one batch row too, and its generic
   route at the slice shape; and at the hybrid train step's shape, the
   RG-LRU kernel and its plain backward.

Every step is traced and its plans searched in two worker processes
(``meta`` tensors, no card) while the card runs the earlier phases, the
small f32 models' prefill and train steps too; each phase takes its
plans as JSON.  The
MoE phases report the full-depth steps' plans and run the cut steps'
plans.  The ``kernels`` line's attention row carries the launches of
each path: ``launches_train_step``, ``launches_mesh``,
``launches_moe``, ``launches_mesh_moe``, ``launches_moe_train_step``,
``launches_moe_train_mesh`` (per rank, phase 7e),
``launches_xlstm`` (phase 7f, 0: a launch fails the phase) and
``launches_whisper`` / ``launches_phi3_vision`` (phase 7g, per request),
``launches_whisper_train`` / ``launches_phi3_vision_train`` /
``launches_xlstm_train`` (phase 7h, per train step),
``launches_whisper_mesh`` / ``launches_phi3_vision_mesh`` /
``launches_xlstm_mesh`` (phase 7i, per rank, for a request and for a
train step), ``launches_store`` (phase 7j, the request through the plan
read back from the plan store), with
``whisper_encoder_shape``, ``whisper_decoder_shape`` and
``phi3_vision_shape`` (the kernel's times there beside its bound, the
plain version and SDPA, and the sites' largest error); the RG-LRU row
carries 0 for those launches too.

Run from the root of a checkout: ``python3 chip_smoke.py [--seed N]``
(the seed of the train path's weights and batch, 0 by default).  Needs one
CUDA card (sm_90a) and ``nvcc``; exits non-zero, printing no result,
without them.  Any failed check raises.  The last line of standard
output is ``{"ok": true, "device": {...}}``; the line before it holds
the kernel measurements as JSON, and the one before that the script's
total seconds.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import contextlib
import dataclasses
import json
import math
import multiprocessing
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

REQUESTS = 3
# per path: prompts x tokens of each request
QWEN_SHAPE = (4, 2048)
HYBRID_SHAPE = (4, 4096)
# kernel vs plain version (tests/test_kernels.py's tolerances)
FA_TOL = {"bfloat16": 2e-2, "float32": 2e-5}
LRU_TOL = {"bfloat16": 3e-2, "float32": 2e-5}
# last-token logits of the bf16 models, kernel sites vs plain sites: the
# two round at different points (attention: the kernel rounds the
# unnormalized probabilities to bf16 and normalizes after the PV
# product; RG-LRU: a sequential f32 recurrence vs an associative scan)
# and the difference compounds over the bf16 layers; bound on
# max|diff| relative to max|plain logits|
LOGITS_REL_TOL = 2e-2
# small f32 model, kernel sites vs plain sites; and its decode logits vs
# its forward through the kernels
SMALL_TOL = 1e-4
# decode path: prompts x tokens of each request, tokens generated, cache
DECODE_SHAPE = (4, 128)
DECODE_GEN = 128
DECODE_MAX_SEQ = 256
# the decode paths of qwen2_05b, recurrentgemma_2b (two periods and its
# tail of two RG-LRU blocks: at 5 layers one served row's greedy token
# was a near tie that the two ranks' bf16 rounding flipped, within 6.1e-3
# of the largest logit) and xlstm_350m (one period: 7 mLSTM + 1 sLSTM),
# and the first two's serves on two ranks in the mesh launcher phase,
# cut in depth: their eager steps are host-bound, about linear in the
# layers (~2.1-3.8 ms a layer and token on one card, as much as ~80 ms
# on two ranks sharing it, by host)
DECODE_DEPTH = {"qwen2_05b": 4, "recurrentgemma_2b": 8, "xlstm_350m": 8,
                "whisper_small": 4, "phi3_vision": 8}
# small f32 models' decode: tokens (past the hybrid's 16-token window)
SMALL_DECODE_TOKENS = 40
# train path: batch x tokens (the prefill path's shape), steps on one
# fixed batch; the optimizer's warmup is short, as the default 100 warmup
# steps would barely move the loss in 8 steps
TRAIN_SHAPE = (4, 2048)
TRAIN_STEPS = 8
TRAIN_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=TRAIN_STEPS)
# the hybrid's train path: one sequence of twice the local window (the
# reference's train length), and the moments in bf16 (the reference's
# option for very large models): with f32 moments the old and the new
# train state of its 3.49 B parameters alone take 69.8 GB
HYBRID_TRAIN_SHAPE = (1, 4096)
HYBRID_TRAIN_OPT = dict(TRAIN_OPT, state_dtype="bfloat16")
# its small f32 model: two periods of (rglru, rglru, local) and a tail
HYBRID_SMALL_LAYERS = 8
# the training launcher at full width (qwen2_05b at TRAIN_SHAPE, cut to
# LAUNCH_DEPTH of its 24 layers; at 6 and at 4 layers a mesh launcher
# step took ~7-10 s on a slow host, the embedding, unembedding and
# gloo's copies setting most of it): steps, a checkpoint every
# LAUNCH_CKPT_EVERY steps, a failure injected at step LAUNCH_FAIL_AT of
# the first attempt
LAUNCH_STEPS = 6
LAUNCH_CKPT_EVERY = 3
LAUNCH_FAIL_AT = 4
LAUNCH_DEPTH = 4
# step 1 through the kernel vs through the plain version: loss and grad
# norm, relative (bf16)
TRAIN_REL_TOL = 2e-2
# the mesh phase: two ranks share card 0 over gloo on a (data 1, model
# 2) mesh; requests per model, the group's wall-clock limit (seconds)
MESH_SHAPE = (1, 2)
MESH_REQUESTS = 2
MESH_TIMEOUT = 420.0
# the mesh launcher phase: the launcher's schedule on (1, 2), then one
# request of 4 x (16 prompt + 16 generated) tokens per model, each at
# its DECODE_DEPTH
MESH_SERVE = (4, 16, 16)
MESH_LAUNCH_TIMEOUT = 600.0
# the MoE models at full width, cut in depth (mixtral_8x22b: 5.008 GB a
# layer in bf16; arctic_480b: 27.22 GB a layer; 4 and 2 layers, what one
# card holds, before the decode-bound steps of their decode paths were
# cut for time), served at the qwen2_05b path's traffic; their plans
# are searched for the full depth
MOE_DEPTH = {"mixtral_8x22b": 2, "arctic_480b": 1}
MOE_SHAPE = (4, 2048)
# the MoE mesh phase: two ranks share card 0 on a (data 1, model 2) mesh,
# each model cut to what two ranks holding its weights whole fit (the
# serving route replicates them): mixtral_8x22b 2 x 5.008 + 0.81 GB,
# arctic_480b 1 x 27.22 + 0.92 GB, twice; requests of MOE_SHAPE per
# model, then one MESH_SERVE request through the serving route; the
# group's wall-clock limit (seconds)
MOE_MESH_DEPTH = {"mixtral_8x22b": 2, "arctic_480b": 1}
MOE_MESH_REQUESTS = 2
MOE_MESH_TIMEOUT = 600.0
# MoE training at full width, cut in depth to what one card holds: a
# mixtral_8x22b layer is 2.504 B parameters (5.008 GB in bf16) and the
# embedding and unembedding 0.805 GB; at 1 layer the parameters, their
# gradients and two bf16 moments take ~23.3 GB, the clipped gradients
# beside the unclipped ones +5.8, the captured step's new parameters and
# moments in the graph's pool before they are written into the donated
# buffers +17.4, AdamW's f32 temporaries of the largest leaf (8, 6144,
# 16384) 3.2 GB each, and the windowed attention's einsum path f32
# scores, probabilities and their cotangent at (1, 48, 4096, 4096) 3.2
# GB each: ~65-70 GB; a second layer adds ~7 x 5.0 GB.  arctic_480b's one
# layer (27.2 GB of weights, ~109 GB with gradients and moments) needs a
# multi-card host.  The step: train_4k's sequence, its batch of 256 cut
# to 1 (as the hybrid's), AdamW with bf16 moments, remat on
MOE_TRAIN_DEPTH = {"mixtral_8x22b": 1}
MOE_TRAIN_SHAPE = (1, 4096)
# MoE training on two ranks of one gloo group sharing card 0 (phase 7e):
# mixtral_8x22b at full width cut to 1 layer, its (1, 2) train plan
# searched with each rank's share of the card as TOAST's memory budget.
# Per rank, the experts and the embeddings sharded two ways: the state
# ~9.0 GB, the step's new state beside it +9.0, the gradients and the
# clipped ones ~3.0 each, AdamW's f32 temporaries of the largest leaf
# (8, 3072, 16384) 1.6 GB each, and at S 4096 the windowed attention's
# f32 scores, probabilities and their cotangent 3.2 GB each (the
# residual runs whole in the sequence, its features sharded): ~36-40 GB
# a rank, near the card's 79.6 GB for both with their CUDA contexts.
# The cut to S 2048 leaves a margin, and one card runs the same steps
# three times at this shape (plain, regrouped, with a planted fault;
# ~66 GB each).  Steps on one fixed batch from the seed; the group's
# wall-clock limit (seconds)
MOE_MESH_TRAIN_DEPTH = {"mixtral_8x22b": 1}
MOE_MESH_TRAIN_SHAPE = (1, 2048)
MOE_MESH_TRAIN_STEPS = 4
MOE_MESH_TRAIN_TIMEOUT = 600.0
# its optimizer: 7d's, at a tenth of the rate: at 1e-3 the 4 steps
# memorize the batch (loss 10.9 -> 0.1), and the last steps' gradients,
# tiny and noisy, leave moments that any regrouping of the bf16 sums
# moves by 20-37% (measured on an H100 80GB HBM3 at 700 W)
MOE_MESH_TRAIN_OPT = dict(HYBRID_TRAIN_OPT, lr=1e-4)
# the xLSTM phase: xlstm_350m at full width and depth, the prefill
# path's shape; its small f32 model has two super-blocks, each with an
# sLSTM (the stock reduced config's 4 layers hold none)
XLSTM = "xlstm_350m"
XLSTM_SHAPE = QWEN_SHAPE
XLSTM_SMALL_LAYERS = 16
# the frontend models' phase: whisper_small at full width and depth, each
# request 4 x (1500 frames + 1500 tokens), 1500 being Whisper's 30-second
# window after its conv stem (ShapeConfig seq_len 3000: the reference's
# specs split it in halves); phi3_vision 4 x (576 patches + 1472 tokens)
WHISPER = "whisper_small"
WHISPER_SHAPE = (4, 3000)
WHISPER_FRAMES = 1500
PHI3V = "phi3_vision"
PHI3V_SHAPE = QWEN_SHAPE
# the train phase of the xLSTM and the frontend models (7h): model ->
# (layers run on the card, None: all; B x S positions; the small f32
# model's layers, None: the reduced config's; remat, None: the
# config's).  phi3_vision keeps 8 of its 32 layers (~1.36 GB of bf16
# weights and gradients and f32 moments a layer: 46 GB at full depth,
# and the captured step holds a second copy of the new state); the
# xLSTM one period of 8 (7 mLSTM + 1 sLSTM), without remat: its period
# fits the card (~13 GB a step), and remat's checkpoint would run the
# sLSTM's 2048-step time loop twice more in each host-bound eager step
# (~8-10 s against ~4); its small f32 model trains with remat
FRONTEND_TRAIN = {WHISPER: (None, WHISPER_SHAPE, None, None),
                  PHI3V: (8, PHI3V_SHAPE, None, None),
                  XLSTM: (8, XLSTM_SHAPE, XLSTM_SMALL_LAYERS, False)}
# the family mesh phase (7i): the xLSTM and the frontend models on two
# ranks sharing card 0, each at full width cut in depth: model ->
# (layers kept, an encoder-decoder's encoder layers too; the prefill
# request's B x S positions; the train step's).  The xLSTM keeps one
# period (7 mLSTM + 1 sLSTM), its request the prefill path's 4 x 2048
# (the sLSTM's 2048-step time loop per shard); its train step runs at 2 x
# 256, its eager backward loop being host-bound too; the xLSTM in f32
# (family_cfg).  whisper keeps 1 encoder and 1 decoder layer, phi3_vision
# 1: at 4 + 4 and 4 the phase took 154.7 s on an H100 and at 2 + 2 and 2
# 103.8-110.7 s, the whole script 938.3-1,006.3 s (each rank's eager
# steps and 31 decode steps host-bound on DTensor's dispatch)
FAMILY_MESH = {XLSTM: (8, XLSTM_SHAPE, (2, 256)),
               WHISPER: (1, WHISPER_SHAPE, WHISPER_SHAPE),
               PHI3V: (1, PHI3V_SHAPE, PHI3V_SHAPE)}
FAMILY_MESH_STEPS = 3
FAMILY_MESH_TIMEOUT = 600.0
# 7e's optimizer rate: a few steps at 1e-3 leave moments too noisy for
# the leaf checks
FAMILY_MESH_OPT = dict(TRAIN_OPT, lr=1e-4)
# whisper's served request attends to 16 frames from the seed, as the
# serving launcher's
SERVE_FRAMES = 16
# the plan store phase (7j): the qwen2_05b prefill step at the path shape,
# co-searched over every mesh of an 8-card node and of two 4-card pods
STORE_MODEL = "qwen2_05b"
STORE_DEVICES = 8
STORE_PODS = (1, 2)
# the router's leaves (its weight and moments), whose gradient is the
# noisiest: checked after step 1 too, and the planted fault of phase 7e
# (its gradient scaled by ROUTER_FAULT) must fail the leaf checks
ROUTER = "['ffn']['wg']"
ROUTER_FAULT = 0.9
# H100 SXM data sheet (dense bf16 FLOP/s, f32 FLOP/s outside the tensor
# cores, HBM bytes/s)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def log(*args) -> None:
    print(*args, flush=True)


def dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device milliseconds of ``fn()`` over ``iters`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def build_all(modules) -> None:
    """Build every kernel library at once (one ``nvcc`` per source)."""
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(modules)) as pool:
        futures = [pool.submit(mod.build) for mod in modules.values()]
    for fut in futures:
        fut.result()
    log(f"[build] {', '.join(modules)} built/loaded in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, mod in modules.items():
        log(f"[build] {name}: {mod.build_dir().name}")
        for line in mod.build_log().splitlines():
            if any(w in line for w in ("Compiling entry", "registers",
                                       "spill", "error")):
                log(f"[build] {name}: {line.strip()}")


def check_fa(fa, torch, gen, B, S, T, H, hd, dtype, causal,
             strided=False) -> float:
    """Attention kernel vs plain version on one shape; max |error|."""
    shape_q, shape_kv = (B, S, H, hd), (B, T, H, hd)
    if strided:
        # q, k, v as views of one packed projection: non-trivial strides
        packed = torch.randn((B, S, 3, H, hd), generator=gen,
                             device="cuda").to(dtype)
        q, k, v = packed[:, :, 0], packed[:, :, 1], packed[:, :, 2]
    else:
        q = torch.randn(shape_q, generator=gen, device="cuda").to(dtype)
        k = torch.randn(shape_kv, generator=gen, device="cuda").to(dtype)
        v = torch.randn(shape_kv, generator=gen, device="cuda").to(dtype)
    out = fa.flash_attention(q, k, v, causal=causal)
    want = fa.reference(q, k, v, causal=causal)
    torch.cuda.synchronize()
    tol = FA_TOL[dtype_name(dtype)]
    err = (out.float() - want.float()).abs().max().item()
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    if not torch.isfinite(out).all():
        raise AssertionError("kernel output is not finite")
    log(f"[kernel] flash_attention B={B} S={S} T={T} H={H} hd={hd} "
        f"{dtype_name(dtype)} causal={causal} strided={strided}: "
        f"max|err|={err:.3e} (tol {tol}) ok")
    return err


def time_fa(fa, torch, gen, card, B, S, H, hd, plain,
            causal=True) -> dict:
    """Times the bf16 kernel, SDPA and optionally the plain version at
    (B, S, H, hd); logs a ``[time]`` line, returns its row."""
    q, k, v = (torch.randn((B, S, H, hd), generator=gen, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))
    kernel_ms = cuda_ms(lambda: fa.flash_attention(q, k, v, causal=causal),
                        20)
    plain_ms = (cuda_ms(lambda: fa.reference(q, k, v, causal=causal), 10)
                if plain else None)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_ms = cuda_ms(lambda: torch.nn.functional.
                         scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=causal), 20)
    # the work this run needs: the (causal: k <= q) pairs, two products
    pairs = S * (S + 1) / 2 if causal else S * S
    flops = 4.0 * B * H * hd * pairs
    nbytes = 4.0 * B * S * H * hd * q.element_size()
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    bound_ms = max(t_ops, t_bytes)
    plain_txt = f"plain {plain_ms:.4f} ms, " if plain else ""
    log(f"[time] {card}: flash_attention B={B} S={S} H={H} hd={hd} bf16 "
        f"{'causal' if causal else 'full'} {kernel_ms:.4f} ms "
        f"({flops / kernel_ms / 1e9:.1f} "
        f"TFLOP/s), {plain_txt}sdpa {library_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} "
        f"MB) -> kernel {bound_ms / kernel_ms:.3%}, sdpa "
        f"{bound_ms / library_ms:.3%} of bound")
    return {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:30",
        "launches": None, "max_abs_err": None,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms}


def check_lru(lru, torch, a, b, label, route) -> tuple[float, object]:
    """RG-LRU kernel vs plain version on one input, launched once on
    ``route``; (max |error|, h)."""
    before = dict(lru.route_launches)
    out = lru.rg_lru(a, b)
    took = {r: n - before[r] for r, n in lru.route_launches.items()}
    if took != {r: int(r == route) for r in lru.ROUTES}:
        raise AssertionError(f"rg_lru {label}: launches by route {took}, "
                             f"expected one on {route}")
    want = lru.reference(a, b)
    torch.cuda.synchronize()
    tol = LRU_TOL[dtype_name(a.dtype)]
    err = (out.float() - want.float()).abs().max().item()
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    if out.dtype != a.dtype or not torch.isfinite(out).all():
        raise AssertionError("kernel output is not finite or of a's dtype")
    log(f"[kernel] rg_lru {label} {tuple(a.shape)} {dtype_name(a.dtype)} "
        f"{route} route: max|err|={err:.3e} (tol {tol}) ok")
    return err, out


def lru_inputs(torch, gen, shape, dtype, lo=None, hi=None):
    """Gates a (sigmoid of normals, or uniform in [lo, hi)), inputs b."""
    if lo is None:
        a = torch.sigmoid(torch.randn(shape, generator=gen, device="cuda"))
    else:
        a = lo + (hi - lo) * torch.rand(shape, generator=gen, device="cuda")
    b = 0.1 * torch.randn(shape, generator=gen, device="cuda")
    return a.to(dtype), b.to(dtype)


def plan_job(kind: str, name: str, depth: int | None = None,
             shape=None, opt_kw=None, hbm: float | None = None,
             small_layers: int | None = None, with_small: bool = True,
             remat: bool | None = None, store_dir: str | None = None,
             written: dict | None = None) -> dict:
    """Host work of one phase, run in the worker process beside the
    card's phases (no card is touched): trace ``name``'s ``kind`` step
    on ``meta`` tensors (``Session``) and search its 2x4 and 1x1 plans.

    ``kind`` is ``"path"`` (the prefill step at ``shape``: its 2x4, 1x1
    and (1, 2) plans, the last as the mesh phase plans it),
    ``"prefill"`` (B x S of ``shape``, by default ``MOE_SHAPE``; a
    frontend model's S split as its specs split it),
    ``"decode"`` (B
    of ``DECODE_SHAPE``, cache ``DECODE_MAX_SEQ``, the serving launcher's
    requests; with it the 1x1 plan of the prefill step on the decode
    path's prompts), ``"train"`` (``shape``, AdamW of ``opt_kw``) or
    ``"mesh"`` (the MoE mesh phase: the prefill step at ``MOE_SHAPE``
    planned for (1, 2) with the default ``Request``, as the mesh phase
    plans its models, and for 1x1; with it the serving launcher's decode
    plan for two devices at ``MESH_SERVE``, whose rules the launcher's
    ``toast_decode_rules`` searches) or ``"mesh train"`` (the train step
    at ``shape``, AdamW of ``opt_kw``, planned for (1, 2) with a
    ``HardwareSpec`` whose ``hbm_per_chip`` is ``hbm``, each rank's
    share of the card) or ``"store"`` (the prefill step at ``shape``
    in a ``Session`` over the plan store at ``store_dir``: see
    :func:`store_job`; ``written`` is the first store job's result).
    ``depth`` cuts the layers and ``remat`` sets the config's remat
    (``None``: the config's).  A ``"path"``
    job, a frontend model's ``"prefill"`` job and the ``"train"`` job of
    a model without experts also plan the small f32 model's step for the
    phase's small check (``"small 1x1"``): its prefill at 2 x 64
    positions, or its train step (remat on, ``small_layers`` layers;
    ``None``: the reduced config's), unless ``with_small`` is false (a step
    whose plans are only reported).  Returns the session's figures, each
    plan's JSON and what was checked on it.
    """
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    import torch
    from repro_torch.api import Request, Session
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.cost_model import MeshSpec
    from repro_torch.core.partitioner import ShardingPlan
    from repro_torch.launch import serve, specs
    from repro_torch.models import transformer as T
    from repro_torch.optim.adam import AdamConfig
    from repro_torch.train import steps as TS

    def meta_tokens(B, S):
        return {"tokens": torch.empty((B, S), dtype=torch.int32,
                                      device="meta")}

    def meta_batch(B, S):
        # a frontend model's batch (its frames or patches and tokens), as
        # the specs split S
        if cfg.is_encoder_decoder or cfg.frontend:
            return specs.batch_specs(cfg, ShapeConfig("prefill", S, B,
                                                      "prefill"))[0]
        return meta_tokens(B, S)

    cfg = dataclasses.replace(get_config(name), use_pallas=True)
    if depth is not None:
        cfg = dataclasses.replace(cfg, num_layers=depth)
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat=remat)
    if kind == "store":
        return store_job(cfg, shape, store_dir, written)
    mesh8 = MeshSpec(("data", "model"), (2, 4))
    mesh1 = MeshSpec(("data", "model"), (1, 1))
    t0 = time.perf_counter()
    if kind in ("train", "mesh train"):
        opt = AdamConfig(**opt_kw)
        bspec, _ = specs.batch_specs(cfg, ShapeConfig("train", shape[1],
                                                      shape[0], "train"))
        sess = Session(TS.make_train_step(cfg, opt),
                       (TS.train_state_specs(cfg, opt), bspec))
        reqs = {"2x4": Request(mesh=mesh8), "1x1": Request(mesh=mesh1)}
        if kind == "mesh train":
            from repro_torch.core.cost_model import HardwareSpec
            reqs = {"1x2": Request(
                mesh=MeshSpec(("data", "model"), MESH_SHAPE),
                hw=dataclasses.replace(HardwareSpec(), hbm_per_chip=hbm))}
    elif kind in ("prefill", "mesh", "path"):
        sess = Session(TS.make_prefill_step(cfg), (T.param_specs(cfg),
                       meta_batch(*(shape or MOE_SHAPE))))
        reqs = {"2x4": Request(mesh=mesh8), "1x1": Request(mesh=mesh1)}
        if kind == "path":
            reqs["1x2"] = Request(mesh=MeshSpec(("data", "model"),
                                                MESH_SHAPE))
        if kind == "mesh":
            reqs = {"1x2": Request(mesh=MeshSpec(("data", "model"),
                                                 MESH_SHAPE)),
                    "1x1": Request(mesh=mesh1)}
    else:
        sess, names = serve.decode_session(cfg, DECODE_SHAPE[0],
                                           DECODE_MAX_SEQ)
        reqs = {"2x4": serve.decode_request(cfg, names, mesh8),
                "1x1": serve.decode_request(cfg, names, mesh1)}
    art = sess.artifacts
    prog = art.prog
    out = {"stats": {
        "ops": len(prog.ops), "colors": len(art.nda.color_summary()),
        "conflicts": len(art.analysis.conflicts),
        "phases": {k: round(v, 4) for k, v in art.phase_seconds.items()},
        "fingerprint": sess.fingerprint[:16],
        "trips": sorted(set(prog.trip_counts.values())),
        "kernel_ops": [op.prim for op in prog.ops
                       if op.prim.startswith("kernel:")]},
        "plans": {}, "constraints": {}}
    for label, req in reqs.items():
        plan = sess.partition(req)
        plan.check(req.constraints)
        if ShardingPlan.from_json(plan.to_json()).as_dict() != \
                plan.as_dict():
            raise AssertionError(f"{name} {kind} {label} plan JSON does "
                                 f"not round-trip")
        out["plans"][label] = plan.to_json()
        out["constraints"][label] = [c.target for c in req.constraints]
    out["seconds"] = time.perf_counter() - t0
    out["hbm"] = hbm
    if kind == "decode":
        # the prefill step on the decode path's prompts (and, for an
        # encoder-decoder, the frames of its 1500-frame batch)
        batch = meta_tokens(*DECODE_SHAPE)
        if cfg.is_encoder_decoder:
            batch = {**meta_batch(DECODE_SHAPE[0], 2 * WHISPER_FRAMES),
                     **batch}
        psess = Session(TS.make_prefill_step(cfg),
                        (T.param_specs(cfg), batch))
        out["plans"]["prefill 1x1"] = psess.partition(
            Request(mesh=mesh1)).to_json()
    if kind == "path" or kind == "prefill" and cfg.frontend:
        small = dataclasses.replace(get_config(name).reduced(),
                                    use_pallas=True)
        ssess = Session(TS.make_prefill_step(small), (
            T.param_specs(small),
            specs.batch_specs(small, ShapeConfig("s", 64, 2, "prefill"))[0]))
        out["plans"]["small 1x1"] = ssess.partition(
            Request(mesh=mesh1)).to_json()
    if kind == "train" and with_small and not cfg.num_experts:
        small = dataclasses.replace(get_config(name).reduced(),
                                    use_pallas=True, remat=True)
        if small_layers is not None:
            small = dataclasses.replace(small, num_layers=small_layers)
        ssess = Session(TS.make_train_step(small, opt), (
            TS.train_state_specs(small, opt),
            specs.batch_specs(small, ShapeConfig("t", 64, 2, "train"))[0]))
        out["plans"]["small 1x1"] = ssess.partition(
            Request(mesh=mesh1)).to_json()
    if kind == "mesh":
        B, P, G = MESH_SERVE
        dsess, names = serve.decode_session(cfg, B, P + G)
        out["decode conflicts"] = len(dsess.artifacts.analysis.conflicts)
        out["plans"]["decode 1x2"] = dsess.partition(serve.decode_request(
            cfg, names, MeshSpec(("data", "model"), MESH_SHAPE))).to_json()
    return out


def store_portfolio():
    """The portfolio the reference's zoo driver searches with
    (``zoo_portfolio``): greedy and a beam of width 4 first, then two
    MCTS seeds of 4 rounds, on two threads, the queued members cancelled
    once two finish without improving the best feasible cost."""
    from repro_torch.core.mcts import MCTSConfig
    from repro_torch.core.portfolio import PortfolioConfig, PortfolioMember
    from repro_torch.core.search import BeamConfig
    members = (
        PortfolioMember("greedy", config=BeamConfig(patience=1)),
        PortfolioMember("beam", config=BeamConfig(width=4, patience=1)),
        *(PortfolioMember("mcts", seed=s, config=MCTSConfig(
            seed=s, rounds=4, trajectories_per_round=16)) for s in range(2)))
    return PortfolioConfig(members=members, max_workers=2, patience=2)


def mesh_label(mesh: dict) -> str:
    """``"2x4"``, or ``"2x2x2 dcn pod"`` for a mesh that crosses pods."""
    label = "x".join(str(n) for n in mesh["sizes"])
    return label + (" dcn " + ",".join(mesh["dcn_axes"])
                    if mesh["dcn_axes"] else "")


def without_provenance(plan) -> dict:
    """A plan's ``as_dict`` but its search seconds (0 on a store hit)."""
    d = plan.as_dict()
    d.pop("search_seconds")
    return d


def store_job(cfg, shape, store_dir: str, written: dict | None) -> dict:
    """The plan store's host work (phase 7j), in a worker process.

    Traces ``cfg``'s prefill step at ``shape`` on ``meta`` tensors in a
    ``Session`` over the plan store at ``store_dir``.  The first job
    (``written`` None) co-searches every mesh of ``STORE_DEVICES`` cards
    in one or two pods with :func:`store_portfolio` and partitions the
    1x1 request with it, each plan written to the store.  The second
    (``written``: the first's result), in another process, must find the
    first's fingerprint and every plan it searched in the store: each
    ``partition`` a hit (``cached``, the store's hits up by one, no cost
    model built), each plan equal to the first job's but its search
    seconds.  Returns the fingerprint, the co-search's rows and each
    plan's JSON by :func:`mesh_label` (the 1x1 plan under ``"1x1"``).
    """
    import torch
    from repro_torch.api import Request, Session
    from repro_torch.ckpt.plan_store import PlanStore
    from repro_torch.core.cost_model import MeshSpec
    from repro_torch.core.partitioner import ShardingPlan
    from repro_torch.models import transformer as T
    from repro_torch.train import steps as TS

    t0 = time.perf_counter()
    store = PlanStore(store_dir)
    tokens = torch.empty(shape, dtype=torch.int32, device="meta")
    sess = Session(TS.make_prefill_step(cfg), (T.param_specs(cfg),
                                               {"tokens": tokens}),
                   plan_store=store)
    out = {"pid": os.getpid(), "fingerprint": sess.fingerprint,
           "ops": len(sess.artifacts.prog.ops),
           "trace_seconds": time.perf_counter() - t0}
    req = Request(mesh=MeshSpec(("data", "model"), (1, 1)),
                  backend="portfolio", search_config=store_portfolio())
    if written is None:
        co = sess.co_search(req, STORE_DEVICES, pods=STORE_PODS)
        plans = {mesh_label(m.as_dict()): p for m, p in co.plans.items()}
        plans["1x1"] = sess.partition(req)
        if any(p.cached for p in plans.values()):
            raise AssertionError("a fresh plan store held a plan")
        mp = co.best_multi_pod()
        out.update(
            rows=co.rows, co_seconds=co.seconds,
            best_mesh=None if co.best_mesh is None
            else mesh_label(co.best_mesh.as_dict()),
            best_multi_pod=None if mp is None
            else [mesh_label(mp[0].as_dict()), mp[1].cost],
            winners={k: p.eval_stats["portfolio"]["winner"]
                     for k, p in plans.items()},
            early_stopped={k: p.eval_stats["portfolio"]["early_stopped"]
                           for k, p in plans.items()},
            plans={k: p.to_json() for k, p in plans.items()},
            entries=len(store), stats=store.stats.as_dict())
    else:
        if out["pid"] == written["pid"]:
            raise AssertionError("the store's read job ran in the process "
                                 "that wrote it")
        if out["fingerprint"] != written["fingerprint"]:
            raise AssertionError(
                f"the fingerprint differs across processes: "
                f"{out['fingerprint']} != {written['fingerprint']}")
        plans = {}
        for label, js in written["plans"].items():
            want = ShardingPlan.from_json(js)
            hits = store.stats.hits
            got = sess.partition(dataclasses.replace(req, mesh=want.mesh))
            if not got.cached or store.stats.hits != hits + 1:
                raise AssertionError(f"{label}: no store hit (cached "
                                     f"{got.cached}, {store.stats})")
            if without_provenance(got) != without_provenance(want):
                raise AssertionError(f"{label}: the stored plan differs "
                                     f"from the one written")
            plans[label] = got.to_json()
        if sess._cost_models or store.stats.misses or store.stats.puts:
            raise AssertionError(f"the read job evaluated: "
                                 f"{len(sess._cost_models)} cost models, "
                                 f"{store.stats}")
        out.update(plans={"1x1": plans["1x1"]}, hits=sorted(plans),
                   stats=store.stats.as_dict())
    out["seconds"] = time.perf_counter() - t0
    return out


def store_jobs(pool, store_dir: str) -> tuple[dict, dict]:
    """The two store jobs (:func:`store_job`), one after the other, in
    ``pool`` (one process a job): the write job's result and the read
    job's."""
    written = pool.submit(plan_job, "store", STORE_MODEL, None, QWEN_SHAPE,
                          store_dir=store_dir).result()
    read = pool.submit(plan_job, "store", STORE_MODEL, None, QWEN_SHAPE,
                       store_dir=store_dir, written=written).result()
    return written, read


def drive_store(torch, counters, card, jobs, want_logits) -> dict:
    """Phase 7j: report the co-search and the store's hits of the two
    store jobs (:func:`store_jobs`), then answer one request of the
    prefill path
    through the 1x1 plan the second read from the store, captured,
    with the seed's weights: 24 attention launches, its last-token
    logits equal to phase 4's (``want_logits``, its captured 1x1 plan on
    the same first request) bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.core.partitioner import ShardingPlan
    from repro_torch.kernels.ops import launch_counts
    from repro_torch.models import transformer as T
    from repro_torch.train.steps import make_prefill_step

    t0 = time.perf_counter()
    written, read = jobs.result()
    wait = time.perf_counter() - t0
    name = STORE_MODEL
    for row in written["rows"]:
        line = (f"[co-search {name}] {mesh_label(row['mesh'])}: "
                f"{row['status']}, peak bound "
                f"{row['peak_lower_bound_gb']:.3f} GiB")
        if row["status"] == "ok":
            label = mesh_label(row["mesh"])
            line += (f", cost {row['cost']:.6f}, feasible "
                     f"{row['feasible']}, peak {row['peak_gb']:.3f} GiB, "
                     f"search {row['search_s']:.3f} s, winner "
                     f"{written['winners'][label]}, early stopped "
                     f"{written['early_stopped'][label]}")
        elif row["status"] == "error":
            line += f", {row['error']}"
        log(line)
    multi = written["best_multi_pod"]
    log(f"[co-search {name}] {STORE_DEVICES} cards, pods {STORE_PODS}: "
        f"best mesh {written['best_mesh']}, best multi-pod "
        + ("none" if multi is None else f"{multi[0]} (cost {multi[1]:.6f})")
        + f"; 1x1 winner "
        f"{written['winners']['1x1']}; the write job (pid "
        f"{written['pid']}): trace {written['trace_seconds']:.1f} s, "
        f"{written['ops']} ops, co-search {written['co_seconds']:.1f} s, "
        f"{written['seconds']:.1f} s in all, {written['entries']} store "
        f"entries, {json.dumps(written['stats'])} (worker process)")
    log(f"[plan store {name}] the read job (pid {read['pid']}, a fresh "
        f"process): fingerprint {read['fingerprint'][:16]} equal to the "
        f"write job's; {len(read['hits'])} hits {read['hits']}, "
        f"{json.dumps(read['stats'])}, no cost model built, each plan "
        f"equal to the one written; {read['seconds']:.1f} s")
    log(f"[plan store {name}] the card waited {wait:.3f} s on the worker")

    plan = ShardingPlan.from_json(read["plans"]["1x1"])
    chose = {r["site"]: r["impl"] for r in plan.kernel_sites}
    if not chose or set(chose.values()) != {"cuda"} or \
            any(not s.startswith("flash_attention:") for s in chose):
        raise AssertionError(f"the stored 1x1 plan's sites chose {chose}")
    cfg = dataclasses.replace(get_config(name), use_pallas=True)
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    (request,) = prefill_requests(
        torch, cfg, torch.Generator(device="cuda").manual_seed(1),
        QWEN_SHAPE, 1)
    applied = plan.apply(make_prefill_step(cfg))
    for mod in counters.values():
        mod.launches = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    logits = applied(params, request)
    end.record()
    torch.cuda.synchronize()
    (graph,) = applied.graphs
    counts = launch_counts()
    # the request: its one replay, as many launches as the capture recorded
    per_request = {k: applied.replays * graph.launches[k] for k in counters}
    want = {k: cfg.num_layers if k == "flash_attention" else 0
            for k in counters}
    if per_request != want or applied.replays != 1 or any(
            counts[k] != graph.warmup_launches[k] + graph.launches[k]
            for k in counters):
        raise AssertionError(
            f"the stored plan's request launched {per_request} "
            f"({applied.replays} replays), expected {want}; counters "
            f"{counts}, warm-up {graph.warmup_launches}")
    got = logits.float().cpu()
    if got.shape != (QWEN_SHAPE[0], cfg.vocab_size) or \
            not torch.isfinite(got).all():
        raise AssertionError("the stored plan's logits are not finite or "
                             "misshapen")
    if not torch.equal(got, want_logits):
        raise AssertionError(
            f"the stored plan's logits differ from phase 4's, max|diff| "
            f"{(got - want_logits).abs().max().item():.3e}")
    log(f"[plan store {name}] the stored 1x1 plan (sites "
        f"{json.dumps(chose)}) captured in {graph.seconds:.3f} s, one "
        f"request of {QWEN_SHAPE[0]} x {QWEN_SHAPE[1]} in "
        f"{start.elapsed_time(end):.3f} ms with the capture: "
        f"flash_attention launches {per_request['flash_attention']} = 1 "
        f"replay x {graph.launches['flash_attention']} recorded (the "
        f"capture's warm-up {graph.warmup_launches['flash_attention']}); "
        f"next tokens {got.argmax(-1).tolist()}; last-token logits equal "
        f"phase 4's captured 1x1 plan's bit for bit")
    applied.release()
    del applied, params, logits
    seconds = time.perf_counter() - t0
    log(f"[elapsed] plan store phase {seconds:.1f} s on the card's "
        f"timeline ({card})")
    return {"launches": per_request, "wait": wait, "seconds": seconds}


def plan_of(job: dict, label: str):
    """The ``ShardingPlan`` of a :func:`plan_job` result."""
    from repro_torch.core.partitioner import ShardingPlan
    return ShardingPlan.from_json(job["plans"][label])


def log_session(cfg, shape, job) -> None:
    """The ``[session ...]`` line of one model's full-width prefill step,
    traced and analyzed on ``meta`` tensors in the worker process (its
    ``"path"`` :func:`plan_job`)."""
    B, S = shape
    st = job["stats"]
    log(f"[session {cfg.name}] B={B} S={S}: {st['ops']} ops, "
        f"{st['colors']} colors, {st['conflicts']} conflicts, phases "
        + json.dumps(st["phases"]) + " (worker process)")


def drive_path(torch, cfg, job, shape, counters, kernel, per_request,
               card, sites=None):
    """Plan and serve one model's prefill path.

    Args:
        cfg: the full-width model configuration (``use_pallas`` set).
        job: the ``"path"`` (or ``"prefill"``) :func:`plan_job` result of
            its prefill step.
        shape: prompts x positions of each request (a frontend model's
            batches: :func:`prefill_requests`).
        counters: kernel name -> its wrapper module (``launches``).
        kernel: the kernel this path runs.
        per_request: that kernel's launches in one request.
        card: the card's name and power limit, for the time lines.
        sites: the 1x1 plan's kernel sites, in order (``None``: any of
            ``kernel``'s).

    Returns:
        The kernel's launches, the RG-LRU's by route, the weights and the
        captured plan's last-token logits of each request.
    """
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.train.steps import make_prefill_step

    B, S = shape
    name = cfg.name
    step = make_prefill_step(cfg)

    plan8 = plan_of(job, "2x4")       # its JSON round trip checked there
    log(f"[partition {name} 2x4] cost={plan8.cost:.6f} "
        f"kernel_sites={len(plan8.kernel_sites)} "
        f"search={plan8.search_seconds:.3f} s "
        f"evaluations={plan8.evaluations} json round-trip ok")

    plan1 = plan_of(job, "1x1")
    chose = {r["site"]: r["impl"] for r in plan1.kernel_sites}
    if not chose or set(chose.values()) != {"cuda"} or \
            any(not s.startswith(kernel + ":") for s in chose) or \
            sites is not None and list(chose) != sites:
        raise AssertionError(f"1x1 plan kernel sites chose {chose}")
    log(f"[partition {name} 1x1] cost={plan1.cost:.6f} sites="
        + json.dumps(chose))
    applied = plan1.apply(step)
    eager = plan1.apply(step, capture=False)
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    tgen = torch.Generator(device="cuda").manual_seed(1)
    requests = prefill_requests(torch, cfg, tgen, shape, REQUESTS)
    eager(params, requests[0])              # warm-up, not counted
    graph = capture_once(torch, applied, f"{name} prefill B={B} S={S}",
                         params, requests[0])
    lru = counters["rg_lru"]
    if graph.launches[kernel] != per_request or \
            graph.warmup_launches[kernel] != per_request or \
            any(graph.launches[k] for k in counters if k != kernel):
        raise AssertionError(f"{name}: the graph recorded launches "
                             f"{graph.launches}, its warm-up "
                             f"{graph.warmup_launches}; expected "
                             f"{per_request} {kernel}")

    def serve(fn, label):
        outs, times = [], []
        for i, req in enumerate(requests):
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            logits = fn(params, req)
            end.record()
            torch.cuda.synchronize()
            if logits.shape != (B, cfg.vocab_size) or \
                    not torch.isfinite(logits).all():
                raise AssertionError(f"{label} request {i}: logits "
                                     f"{tuple(logits.shape)} not finite "
                                     f"or misshapen")
            ids = logits.float().argmax(-1).tolist()
            times.append(start.elapsed_time(end))
            log(f"[serve {name} {label}] request {i}: next tokens {ids} "
                f"prefill {times[-1]:.3f} ms, peak "
                f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
            outs.append(logits.float())
        return outs, times

    def counted(fn, label):
        """Serves the requests through ``fn``; its launches from zero,
        each replay of the graph counted as the launches it recorded."""
        for mod in counters.values():
            mod.launches = 0
        lru.route_launches = dict.fromkeys(lru.ROUTES, 0)
        replays, captures = applied.replays, applied.captures
        outs, times = serve(fn, label)
        if applied.captures != captures:
            raise AssertionError(f"{label}: a request captured a new graph")
        launches = graph_launches(counters, applied, replays)
        want = {k: per_request * REQUESTS if k == kernel else 0
                for k in counters}
        got = {k: launches[k] for k in counters}
        routes = {r: launches[f"rg_lru.{r}"] for r in lru.ROUTES}
        if got != want:
            raise AssertionError(f"{name} {label}: kernel launches {got}, "
                                 f"expected {want}")
        if routes != {"tma": got["rg_lru"], "generic": 0}:
            raise AssertionError(f"{name} {label}: rg_lru launches by "
                                 f"route {routes}, expected all on the TMA "
                                 f"ring")
        log(f"[serve {name} {label}] {kernel} launches {got[kernel]} = "
            f"{per_request} x {REQUESTS} ({applied.replays - replays} "
            f"replays x {graph.launches[kernel]} recorded + "
            f"{sum(mod.launches for mod in counters.values())} eager)")
        return outs, times, got, routes

    kernel_logits, cap_ms, launches, routes = counted(applied, "captured")
    eager_logits, eager_ms, _, _ = counted(eager, "eager")
    for i, (a, b) in enumerate(zip(kernel_logits, eager_logits)):
        if not torch.equal(a, b):
            raise AssertionError(
                f"{name} request {i}: captured and eager logits differ, "
                f"max|diff| {(a - b).abs().max().item():.3e}")
        log(f"[serve {name}] request {i}: captured logits equal eager bit "
            f"for bit")
    # a second round in the other order, for the spread
    eager_ms += serve(eager, "eager")[1]
    cap_ms += serve(applied, "captured")[1]
    if applied.captures != 1:
        raise AssertionError(f"{name}: {applied.captures} captures of one "
                             f"signature")
    log(f"[prefill time] {card}: {name} B={B} S={S} per request, captured "
        f"{fmt_ms(cap_ms)} (median {percentile(cap_ms, 0.5):.3f}), eager "
        f"{fmt_ms(eager_ms)} (median {percentile(eager_ms, 0.5):.3f}); "
        f"capture {graph.seconds:.3f} s, graph pool "
        f"{graph.pool_bytes / 1e9:.3f} GB, {applied.replays} replays")
    del graph, eager
    applied.release()
    plain_plan = dataclasses.replace(
        plan1, kernel_sites=[{**r, "impl": "ref"}
                             for r in plan1.kernel_sites])
    before = {k: mod.launches for k, mod in counters.items()}
    plain_logits = serve(plain_plan.apply(step, capture=False), "plain")[0]
    if {k: mod.launches for k, mod in counters.items()} != before:
        raise AssertionError("the plain path launched a kernel")
    for i, (a, b) in enumerate(zip(kernel_logits, plain_logits)):
        rel = ((a - b).abs().max() / b.abs().max()).item()
        agree = (a.argmax(-1) == b.argmax(-1)).sum().item()
        log(f"[serve {name}] request {i}: max|kernel-plain|/max|plain| = "
            f"{rel:.3e} (tol {LOGITS_REL_TOL}), argmax agree {agree}/{B}")
        if rel > LOGITS_REL_TOL:
            raise AssertionError("kernel and plain logits disagree")

    # the small f32 model, its plan traced in the worker process
    small = dataclasses.replace(get_config(name).reduced(), use_pallas=True)
    small_step = make_prefill_step(small)
    (small_batch,) = prefill_requests(torch, small, tgen, (2, 64), 1)
    small_plan = plan_of(job, "small 1x1")
    small_params = T.init_params(
        small, torch.Generator(device="cuda").manual_seed(2))
    got = small_plan.apply(small_step)(small_params, small_batch)
    want = dataclasses.replace(
        small_plan, kernel_sites=[{**r, "impl": "ref"} for r in
                                  small_plan.kernel_sites]
    ).apply(small_step)(small_params, small_batch)
    torch.testing.assert_close(got, want, rtol=SMALL_TOL, atol=SMALL_TOL)
    log(f"[small] {small.name} ({small.num_layers} layers) f32 logits "
        f"kernel vs plain: max|diff| {(got - want).abs().max().item():.3e} "
        f"(tol {SMALL_TOL}) ok")
    return launches[kernel], routes, params, kernel_logits


def mesh_rank(rank, jobs, shapes, n_requests):
    """One of the two ranks that share card 0 in the mesh phase.

    For each model: apply its (1, 2) plan (read from JSON) to the seeded
    weights, place them once, then answer ``n_requests`` requests, each
    timed on the host clock with the card synchronized, under
    ``CommDebugMode`` and the collective tally.  The first request is
    also the first call (kernels loaded, DTensor's caches filled): a
    full-width hybrid request takes about a minute here, so no request
    is spent on a warm-up alone.  Returns, per model, the gathered
    last-token logits and what the rank counted."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.configs import get_config
    from repro_torch.core.partitioner import ShardingPlan
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import rg_lru as lru
    from repro_torch.launch.mesh import collective_tally
    from repro_torch.models import sharding
    from repro_torch.models import transformer as T
    from repro_torch.train.steps import make_prefill_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for name, plan_json in jobs.items():
        cfg = dataclasses.replace(get_config(name), use_pallas=True)
        B, S = shapes[name]
        applied = ShardingPlan.from_json(plan_json).apply(
            make_prefill_step(cfg))
        t0 = time.perf_counter()
        params = T.init_params(cfg,
                               torch.Generator(device="cuda").manual_seed(0))
        tgen = torch.Generator(device="cuda").manual_seed(1)
        requests = [{"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                             generator=tgen, device="cuda",
                                             dtype=torch.int32)}
                    for _ in range(n_requests)]
        params = applied.place((params, requests[0]))[0]
        torch.cuda.synchronize()
        place_s = time.perf_counter() - t0
        fa.launches = lru.launches = 0
        lru.route_launches = dict.fromkeys(lru.ROUTES, 0)
        ops.local_calls.clear()
        sharding.made_whole.clear()
        sharding.local_ops.clear()
        copies = ops.site_copies
        torch.cuda.reset_peak_memory_stats()
        ms, logits = [], []
        comm_counts, calls, nbytes, comm_s = (collections.Counter() for _ in
                                              range(4))
        for req in requests:
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with CommDebugMode() as comm, collective_tally() as tally:
                y = applied(params, req)
                torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            comm_counts.update({str(k): v for k, v in
                                comm.get_comm_counts().items()})
            calls.update(tally.calls)
            nbytes.update(tally.bytes)
            comm_s.update(tally.seconds)
            logits.append(y.full_tensor().float().cpu())
        out[name] = {
            "logits": logits, "ms": ms, "place_s": place_s,
            "comm_counts": dict(comm_counts), "calls": dict(calls),
            "bytes": dict(nbytes), "comm_s": dict(comm_s),
            "launches": {"flash_attention": fa.launches,
                         "rg_lru": lru.launches},
            "routes": dict(lru.route_launches),
            "local_calls": [[k, impl, shapes, strides, n] for
                            (k, impl, shapes, strides), n in
                            ops.local_calls.items()],
            "copies": ops.site_copies - copies,
            "made_whole": dict(sharding.made_whole),
            "local_ops": dict(sharding.local_ops),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        del params, applied, requests, y
        torch.cuda.empty_cache()
    return out


def drive_mesh(torch, sessions, shapes, per_request, card) -> dict:
    """The mesh phase: plan each model's full-width prefill for a (1, 2)
    mesh and answer requests on two ranks sharing card 0 over gloo.

    Args:
        sessions: model name -> its prefill step's ``"path"``
            :func:`plan_job` result (its (1, 2) plan).
        shapes: model name -> prompts x tokens of each request.
        per_request: model name -> (its kernel, launches per request).
        card: the card's name and power limit, for the time lines.

    Returns:
        Model name -> the two ranks' results (:func:`mesh_rank`).
    """
    from repro_torch.launch.mesh import run_ranks

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"[mesh] before the ranks the parent holds "
        f"{torch.cuda.memory_reserved() / 1e9:.3f} GB reserved, "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB allocated")
    jobs = {}
    for name, job in sessions.items():
        plan = plan_of(job, "1x2")
        specs = collections.Counter(str(tuple(s)) for s in plan.in_specs)
        sharded = {r["site"]: str(tuple(r["in_specs"][0]))
                   for r in plan.kernel_sites if r["sharded"]}
        impls = {r["impl"] for r in plan.kernel_sites}
        log(f"[mesh plan {name} 1x2] cost={plan.cost:.6f} comm_bytes="
            f"{plan.breakdown['comm_bytes']:.0f} in_specs "
            + json.dumps(dict(specs)) + " out_specs "
            + json.dumps([str(tuple(s)) for s in plan.out_specs])
            + f"; sharded kernel sites {json.dumps(sharded)}, "
            f"{len(plan.kernel_sites) - len(sharded)} unsharded")
        if not sharded or impls != {"cuda"}:
            raise AssertionError(f"{name}: the 1x2 plan shards no kernel "
                                 f"site or leaves the kernel ({impls})")
        jobs[name] = plan.to_json()
    t0 = time.perf_counter()
    ranks = run_ranks(mesh_rank, 2, jobs, shapes, MESH_REQUESTS,
                      timeout=MESH_TIMEOUT)
    wall = time.perf_counter() - t0
    for name in jobs:
        kernel, n = per_request[name]
        for rank, res in enumerate(r[name] for r in ranks):
            want = {k: n * MESH_REQUESTS if k == kernel else 0
                    for k in res["launches"]}
            log(f"[mesh {name} rank {rank}] kernel launches "
                + json.dumps(res["launches"]) + " (rg_lru routes "
                + json.dumps(res["routes"]) + f"), local copies "
                f"{res['copies']}, made whole "
                + json.dumps(res["made_whole"]) + ", local elementwise ops "
                + json.dumps(res["local_ops"]))
            for k, impl, shapes_, strides, calls in res["local_calls"]:
                log(f"[mesh {name} rank {rank}] local {k} ({impl}) x{calls}:"
                    f" shapes {shapes_} strides {strides}")
            log(f"[mesh {name} rank {rank}] collectives per "
                f"{MESH_REQUESTS} requests: CommDebugMode "
                + json.dumps(res["comm_counts"]) + ", result bytes by kind "
                + json.dumps(res["bytes"]) + ", host s in them and in "
                "their waits " + json.dumps(
                    {k: round(v, 3) for k, v in res["comm_s"].items()}))
            log(f"[mesh time] {card}: {name} rank {rank} per request "
                f"{fmt_ms(res['ms'])} (the first is the first call; two "
                f"ranks time-sharing one H100 over gloo: not a multi-card "
                f"figure); place {res['place_s']:.3f} s, peak "
                f"{res['peak_gb']:.2f} GB")
            if res["launches"] != want:
                raise AssertionError(f"{name} rank {rank}: kernel launches "
                                     f"{res['launches']}, expected {want}")
            # the plans shard the batch and the weights on one axis: as
            # GSPMD, the port gathers weights and reduces no activation
            reduced = {k: v for k, v in res["calls"].items()
                       if k.startswith(("all_reduce", "reduce_scatter"))}
            if reduced:
                raise AssertionError(f"{name} rank {rank}: activation "
                                     f"reductions {reduced}; GSPMD issues "
                                     f"none for this plan")
            # every RG-LRU launch on the TMA ring, as on one card; no
            # local shard copied for a kernel
            routes = {"tma": want.get("rg_lru", 0), "generic": 0}
            if res["routes"] != routes or res["copies"]:
                raise AssertionError(
                    f"{name} rank {rank}: rg_lru routes {res['routes']} "
                    f"(expected {routes}), {res['copies']} local copies "
                    f"(expected 0)")
            if not all(torch.isfinite(x).all() for x in res["logits"]):
                raise AssertionError(f"{name} rank {rank}: logits not "
                                     f"finite")
        for a, b in zip(ranks[0][name]["logits"], ranks[1][name]["logits"]):
            if not torch.equal(a, b):
                raise AssertionError(f"{name}: the ranks gathered different "
                                     f"logits")
    log(f"[mesh] two ranks, both models: {wall:.1f} s wall, the ranks' "
        f"start included")
    return {name: [r[name] for r in ranks] for name in jobs}


def check_mesh(torch, name, ranks, kernel_logits) -> None:
    """Hold the mesh phase's gathered logits against the one-card
    captured plan's on the same requests."""
    for i, got in enumerate(ranks[0]["logits"]):
        want = kernel_logits[i].cpu()
        rel = ((got - want).abs().max() / want.abs().max()).item()
        same = torch.equal(got.argmax(-1), want.argmax(-1))
        log(f"[mesh {name}] request {i}: 1x2 on two ranks vs 1x1 captured: "
            f"max|diff|/max|1x1| = {rel:.3e} (tol {LOGITS_REL_TOL}), argmax "
            f"{'equal' if same else 'differs'}")
        if rel > LOGITS_REL_TOL or not same:
            raise AssertionError(f"{name}: mesh and one-card logits disagree")


def fmt_ms(xs) -> str:
    return "[" + ", ".join(f"{x:.3f}" for x in xs) + "] ms"


def capture_once(torch, applied, label, *args):
    """The first call of ``applied`` on ``args``: captures its one graph;
    logs its seconds and its pool's bytes; returns the graph."""
    if applied.captures:
        raise AssertionError(f"{label}: captured before its first call")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_stats()["reserved_bytes.all.current"]
    applied(*args)
    torch.cuda.synchronize()
    after = torch.cuda.memory_stats()["reserved_bytes.all.current"]
    (graph,) = applied.graphs
    log(f"[capture {label}] 1 graph in {graph.seconds:.3f} s, pool "
        f"{graph.pool_bytes / 1e9:.3f} GB (reserved {reserved / 1e9:.3f} -> "
        f"{after / 1e9:.3f} GB), launches recorded "
        f"{json.dumps(graph.launches)}, in its warm-up "
        f"{json.dumps(graph.warmup_launches)}")
    return graph


def graph_launches(counters, applied, replays) -> dict:
    """Kernel launches since the counters were zeroed: the wrappers'
    counts plus each replay of ``applied``'s graphs since ``replays``
    counted as the launches its capture recorded."""
    from repro_torch.kernels.ops import launch_counts
    counts = launch_counts()
    n = applied.replays - replays
    (graph,) = applied.graphs
    return {k: counts[k] + n * graph.launches[k] for k in counts}


def state_diffs(torch, host, state) -> dict:
    """Per leaf path of ``state``: max |host leaf - leaf|, 0.0 where the
    two are equal bit for bit (``host``: the leaves of another state,
    copied to the host, in flattening order)."""
    from repro_torch import pytree
    leaves, paths = pytree.flatten_with_paths(state)
    out = {}
    for path, h, x in zip(paths, host, leaves):
        x = x.cpu()
        out[path] = 0.0 if torch.equal(h, x) else \
            (h.double() - x.double()).abs().max().item()
    return out


def percentile(xs, q: float) -> float:
    """The ``q``-quantile of ``xs`` (linear between ranks)."""
    xs = sorted(xs)
    pos = q * (len(xs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def tree_bytes(tree) -> int:
    """Bytes of every tensor leaf of ``tree``."""
    from repro_torch import pytree
    return sum(x.numel() * x.element_size()
               for x in pytree.tree_leaves(tree))


def cut_depth(cfg, params, depth: int):
    """``cfg`` cut to its first ``depth`` layers, and the parameters of
    those layers (views of ``params``'s stacks)."""
    from repro_torch import pytree
    from repro_torch.models import transformer as T
    cut = dataclasses.replace(cfg, num_layers=depth)
    n, tail = T.n_scan_blocks(cut), T.block_kinds(cut)[1]
    if tail != T.block_kinds(cfg)[1][:len(tail)]:
        raise ValueError(f"{cfg.name} cut to {depth} layers ends in "
                         f"{tail}, its full depth otherwise")
    return cut, {**params,
                 "layers": tuple(pytree.tree_map(lambda x: x[:n], stack)
                                 for stack in params["layers"]),
                 "tail": params["tail"][:len(tail)]}


def drive_decode(torch, cfg, params, counters, card, job,
                 small=None) -> None:
    """Plan and serve one model's decode path with ``params``.

    An encoder-decoder model (whisper) decodes against the encoder's
    output of ``WHISPER_FRAMES`` frames per request (``transformer.encode``
    through the kernel, before the counted run), which every decode step
    reads; its prefill check runs on the same frames.

    Args:
        cfg: the full-width model configuration.
        params: its parameters on the card (those of the prefill path).
        counters: kernel name -> its wrapper module (``launches``).
        card: the card's name and power limit, for the time lines.
        job: the :func:`plan_job` result of its decode step (the session
            traced and the plans searched in the worker process).
        small: the small f32 model whose decode is held against its
            forward (``None``: the config's ``reduced()``).
    """
    from repro_torch import pytree
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.models.sharding import KernelDispatch, kernel_dispatch
    from repro_torch.train.steps import make_decode_step, make_prefill_step

    B, P = DECODE_SHAPE
    name = cfg.name
    st = job["stats"]
    log(f"[decode session {name}] {cfg.num_layers} layers, B={B} "
        f"cache={DECODE_MAX_SEQ}: "
        f"{st['ops']} ops, {st['colors']} colors, {st['conflicts']} "
        f"conflicts, phases " + json.dumps(st["phases"]) + " (worker "
        "process)")
    plan8 = plan_of(job, "2x4")
    log(f"[decode partition {name} 2x4] cost={plan8.cost:.6f} constraints="
        f"{job['constraints']['2x4']} satisfied, rules="
        f"{json.dumps(plan8.logical_rules)} search="
        f"{plan8.search_seconds:.3f} s json round-trip ok")
    plan1 = plan_of(job, "1x1")
    if plan1.kernel_sites:
        raise AssertionError(f"decode 1x1 plan has kernel sites "
                             f"{plan1.kernel_sites}")
    log(f"[decode partition {name} 1x1] cost={plan1.cost:.6f} no kernel "
        f"sites")
    decode = plan1.apply(make_decode_step(cfg))
    decode_eager = plan1.apply(make_decode_step(cfg), capture=False)

    # the prefill step on the same prompts, through its 1x1 plan
    pstep = make_prefill_step(cfg)
    pplan = plan_of(job, "prefill 1x1")
    has_sites = any(sum(n) for n in T.kernel_sites(cfg).values())
    if {r["impl"] for r in pplan.kernel_sites} != \
            ({"cuda"} if has_sites else set()):
        raise AssertionError(f"prefill 1x1 plan sites {pplan.kernel_sites}")
    prefill = pplan.apply(pstep)

    tgen = torch.Generator(device="cuda").manual_seed(3)
    prompts = [torch.randint(0, cfg.vocab_size, (B, P), generator=tgen,
                             device="cuda", dtype=torch.int32)
               for _ in range(REQUESTS)]
    frames, enc_outs = [None] * REQUESTS, [None] * REQUESTS
    if cfg.is_encoder_decoder:
        frames = [torch.randn((B, WHISPER_FRAMES, cfg.d_model),
                              generator=tgen, device="cuda")
                  for _ in range(REQUESTS)]
        enc_outs = [T.encode(cfg, params, f) for f in frames]
    extra = () if enc_outs[0] is None else (enc_outs[0],)
    # warm-up, not counted: eager, then the capture of the decode step's
    # one signature (every prompt and generating step shares it)
    serve.serve_loop(decode_eager, params,
                     T.init_cache(cfg, B, DECODE_MAX_SEQ), prompts[0][:, :4],
                     4, enc_outs[0])
    graph = capture_once(torch, decode, f"{name} decode B={B} cache="
                         f"{DECODE_MAX_SEQ}", params,
                         T.init_cache(cfg, B, DECODE_MAX_SEQ),
                         prompts[0][:, :1], torch.zeros((), dtype=torch.int32,
                                                        device="cuda"),
                         *extra)
    if any(graph.launches.values()) or any(graph.warmup_launches.values()):
        raise AssertionError(f"the decode graph recorded kernel launches "
                             f"{graph.launches}")
    for mod in counters.values():
        mod.launches = 0
    replays = decode.replays
    results = {"captured": [], "eager": []}
    steps = {"captured": [], "eager": []}
    for i, pr in enumerate(prompts):
        # in turns: captured first for even requests, eager for odd
        order = ("captured", "eager") if i % 2 == 0 else ("eager", "captured")
        for label in order:
            fn = decode if label == "captured" else decode_eager
            cache = T.init_cache(cfg, B, DECODE_MAX_SEQ)
            torch.cuda.reset_peak_memory_stats()
            res = serve.serve_loop(fn, params, cache, pr, DECODE_GEN,
                                   enc_outs[i])
            peak = torch.cuda.max_memory_allocated() / 1e9
            if res.tokens.shape != (B, DECODE_GEN) or \
                    not torch.isfinite(res.prompt_logits).all() or \
                    not bool(((res.tokens >= 0) &
                              (res.tokens < cfg.vocab_size)).all()):
                raise AssertionError(f"decode request {i} {label}: bad "
                                     f"tokens or logits")
            med = percentile(res.step_ms, 0.5)
            steps[label] += res.step_ms
            log(f"[decode {name} {label}] request {i}: prefill by decode {P} "
                f"tokens {res.prefill_ms:.3f} ms ({res.prefill_ms / P:.3f} "
                f"ms/token), decode {DECODE_GEN} tokens: median {med:.3f} "
                f"ms/token, p90 {percentile(res.step_ms, 0.9):.3f} ms, peak "
                f"{peak:.2f} GB; first tokens {res.tokens[0, :8].tolist()}")
            results[label].append(res)
    launches = graph_launches(counters, decode, replays)
    launches = {k: launches[k] for k in counters}
    if any(launches.values()):
        raise AssertionError(f"the decode path launched kernels {launches}")
    if decode.captures != 1 or \
            decode.replays - replays != REQUESTS * (P + DECODE_GEN - 1):
        raise AssertionError(f"decode: {decode.captures} captures, "
                             f"{decode.replays - replays} replays")
    log(f"[decode {name}] kernel launches on the decode path: "
        + json.dumps(launches) + f" ({decode.replays - replays} replays of "
        f"1 graph)")
    for i, (got, want) in enumerate(zip(results["captured"],
                                        results["eager"])):
        same = {"tokens": torch.equal(got.tokens, want.tokens),
                "prompt logits": torch.equal(got.prompt_logits,
                                             want.prompt_logits),
                "cache": all(torch.equal(a, b) for a, b in zip(
                    pytree.tree_leaves(got.cache),
                    pytree.tree_leaves(want.cache)))}
        if not all(same.values()):
            raise AssertionError(f"decode request {i}: captured and eager "
                                 f"differ: {same}")
        log(f"[decode {name}] request {i}: {B} x {DECODE_GEN} greedy tokens "
            f"identical, prompt logits and the final cache "
            f"({len(pytree.tree_leaves(got.cache))} leaves) equal bit for "
            f"bit, captured vs eager")

    for i, (pr, res) in enumerate(zip(prompts, results["captured"])):
        pbatch = {"tokens": pr}
        if frames[i] is not None:
            pbatch["frames"] = frames[i]
        want = prefill(params, pbatch).float()
        got = res.prompt_logits[:, 0].float()
        rows = list(range(B))
        if cfg.num_experts:
            # decode routes one token at a time (C = 1) and drops none;
            # prefill drops tokens beyond capacity: hold only the rows
            # whose prompt lost no routed token in any layer, and every
            # row against the prefill whose capacity is the whole prompt
            with MoESelections() as sel:
                pplan.apply(pstep, capture=False)(params, {"tokens": pr})
            drops = sel.drops()
            rows = [b for b in range(B) if not drops[:, b].any()]
            whole = dataclasses.replace(
                cfg, moe_capacity_factor=cfg.num_experts /
                cfg.experts_per_token)
            with kernel_dispatch(KernelDispatch(default_impl="cuda")):
                nodrop = make_prefill_step(whole)(
                    params, {"tokens": pr}).float()
            rel = ((got - nodrop).abs().max() / nodrop.abs().max()).item()
            agree = (got.argmax(-1) == nodrop.argmax(-1)).sum().item()
            log(f"[decode {name}] request {i}: prefill of the prompt "
                f"dropped routed tokens per layer and row "
                f"{drops.tolist()}; rows held against it {rows}; against "
                f"the prefill at capacity {P} (none dropped): "
                f"max|decode-prefill|/max|prefill| = {rel:.3e} (tol "
                f"{LOGITS_REL_TOL}), argmax agree {agree}/{B}")
            if rel > LOGITS_REL_TOL:
                raise AssertionError("decode and the no-drop prefill "
                                     "logits disagree")
            if not rows:
                continue
        got, want = got[rows], want[rows]
        rel = ((got - want).abs().max() / want.abs().max()).item()
        agree = (got.argmax(-1) == want.argmax(-1)).sum().item()
        log(f"[decode {name}] request {i}: last prompt token, "
            f"max|decode-prefill|/max|prefill| = {rel:.3e} (tol "
            f"{LOGITS_REL_TOL}), argmax agree {agree}/{len(rows)}")
        if rel > LOGITS_REL_TOL:
            raise AssertionError("decode and prefill logits disagree")
    if prefill.captures != 1 or prefill.replays != REQUESTS:
        raise AssertionError(f"prefill B={B} S={P}: {prefill.captures} "
                             f"captures, {prefill.replays} replays")
    (pgraph,) = prefill.graphs
    log(f"[capture {name} prefill B={B} S={P}] 1 graph in "
        f"{pgraph.seconds:.3f} s, pool {pgraph.pool_bytes / 1e9:.3f} GB, "
        f"{prefill.replays} replays")

    # the bound: every weight read once (of the embedding table only the
    # B rows the step gathers) and the cache read once, at HBM rate
    embed = params["embed"]
    w_bytes = tree_bytes(params) - embed.numel() * \
        embed.element_size() + B * embed.shape[1] * embed.element_size()
    c_bytes = tree_bytes(T.init_cache(cfg, B, DECODE_MAX_SEQ,
                                             device="meta"))
    # an encoder-decoder's cross-attention recomputes its keys and values
    # from the encoder's output in every layer and step: each layer reads
    # enc_out once (a fused step never writes K and V out), and the K/V
    # projections' operations bound the step too
    x_bytes = x_flops = 0.0
    if enc_outs[0] is not None:
        e = enc_outs[0]
        kv = 2 * B * e.shape[1] * cfg.num_kv_heads * cfg.resolved_head_dim
        x_bytes = cfg.num_layers * e.numel() * e.element_size()
        x_flops = cfg.num_layers * 2.0 * kv * cfg.d_model
    t_bytes = (w_bytes + c_bytes + x_bytes) / PEAK_HBM_BYTES * 1e3
    bound_ms = max(t_bytes, x_flops / PEAK_BF16_FLOPS * 1e3)
    times = []
    for label in ("captured", "eager"):
        med = percentile(steps[label], 0.5)
        times.append(f"{label} median {med:.3f} ms, p90 "
                     f"{percentile(steps[label], 0.9):.3f} ms = "
                     f"{med / bound_ms:.1f}x the bound")
    cross = (f" + cross-attention's enc_out reads {x_bytes / 1e6:.2f} MB "
             f"({x_flops / 1e9:.2f} GFLOP of K/V projections at 989 "
             f"TFLOP/s)" if x_bytes else "")
    log(f"[decode bound] {card}: {name} weights {w_bytes / 1e6:.2f} MB + "
        f"cache {c_bytes / 1e6:.2f} MB{cross} -> {bound_ms:.4f} ms per "
        f"token at 3.35 TB/s; over {REQUESTS} x {DECODE_GEN - 1} steps each: "
        + "; ".join(times) + f"; capture {graph.seconds:.3f} s, graph pool "
        f"{graph.pool_bytes / 1e9:.3f} GB")
    del results, graph, pgraph, enc_outs, frames
    decode.release()
    prefill.release()
    del prefill, decode, decode_eager

    # small f32 model: decode logits at every position vs its forward
    # through the kernels
    small = dataclasses.replace(small or get_config(name).reduced(),
                                use_pallas=True)
    sp = T.init_params(small, torch.Generator(device="cuda").manual_seed(4))
    S = SMALL_DECODE_TOKENS
    toks = torch.randint(0, small.vocab_size, (2, S), generator=tgen,
                         device="cuda", dtype=torch.int32)
    kw, extra = {}, ()
    if small.is_encoder_decoder:
        kw["frames"] = torch.randn((2, 64, small.d_model), generator=tgen,
                                   device="cuda")
    before = {k: mod.launches for k, mod in counters.items()}
    with kernel_dispatch(KernelDispatch(default_impl="cuda")):
        want = T.forward(small, sp, toks, **kw)
        if kw:
            extra = (T.encode(small, sp, kw["frames"]),)
    ran = [k for k, mod in counters.items() if mod.launches > before[k]]
    if not ran and any(sum(n) for n in T.kernel_sites(small).values()):
        raise AssertionError("the small forward launched no kernel")
    step = make_decode_step(small)
    cache = T.init_cache(small, 2, S)
    outs = []
    for t in range(S):
        logits, cache = step(sp, cache, toks[:, t:t + 1],
                             torch.tensor(t, dtype=torch.int32,
                                          device="cuda"), *extra)
        outs.append(logits[:, 0])
    got = torch.stack(outs, 1)
    torch.testing.assert_close(got, want, rtol=SMALL_TOL, atol=SMALL_TOL)
    ring = {k: v.shape[2] for k, v in (
        (i, c["k"]) for i, c in enumerate(cache["layers"]) if "k" in c)}
    log(f"[small decode] {small.name} ({small.num_layers} layers) f32, "
        f"{S} tokens, attention ring slots {ring}: decode vs forward "
        f"through {ran}: max|diff| {(got - want).abs().max().item():.3e} "
        f"(tol {SMALL_TOL}) ok")


class MoESelections:
    """Records the capacity selections of the MoE layers an eager run
    makes (``layers.top_k`` wrapped while the context is open).

    Each MoE layer calls ``top_k`` twice, the router's top k and then
    the capacity selection over its tokens, so the calls alternate.
    """

    def __enter__(self):
        from repro_torch.models import layers as L
        self.calls, self._top_k = [], L.top_k

        def recorded(x, k):
            out = self._top_k(x, k)
            self.calls.append((x, *out))
            return out

        L.top_k = recorded
        return self

    def __exit__(self, *exc):
        from repro_torch.models import layers as L
        L.top_k = self._top_k

    def selected(self) -> list:
        """Per layer, the (B, E, C) tokens each expert of each row took."""
        return [idx for _, _, idx in self.calls[1::2]]

    def drops(self):
        """(layers, B): the routed (token, expert) pairs of each row that
        found no room, per layer (batch dispatch)."""
        import torch
        return torch.stack([(x > 0).sum((-1, -2)) - (w > 0).sum((-1, -2))
                            for x, w, _ in self.calls[1::2]]).cpu()


def remat_selections(record, cfg, label: str, i: int) -> dict:
    """One eager train step's capacity selections (``record``: the
    :class:`MoESelections` around it; with remat the forward's calls,
    then the backward's recomputation, last layer first): per layer the
    routed pairs the forward dropped to capacity, and the router's top-k
    picks and the tokens each expert took that the recomputation chose
    otherwise than the forward.  Raises if any differs."""
    n = cfg.num_layers
    calls = record.calls
    if len(calls) != 2 * n * (1 + cfg.remat):
        raise AssertionError(f"{label} step {i}: {len(calls)} top_k calls "
                             f"for {n} MoE layers")
    fwd = [calls[2 * j:2 * j + 2] for j in range(n)]
    again = [calls[2 * n + 2 * j:2 * n + 2 * j + 2]
             for j in range(n)][::-1] if cfg.remat else fwd
    drops = [int((cap[0] > 0).sum() - (cap[1] > 0).sum())
             for _, cap in fwd]
    router = [int((f[0][2] != r[0][2]).sum()) for f, r in zip(fwd, again)]
    tokens = [moved(f[1][2], r[1][2], f[1][0].shape[-1])
              for f, r in zip(fwd, again)]
    log(f"[train {cfg.name} {label}] step {i}: routed pairs dropped to "
        f"capacity per layer {drops} of "
        f"{cfg.experts_per_token * fwd[0][0][0].shape[:-1].numel()}"
        f"; remat's recomputation chose otherwise router picks {router}, "
        f"expert tokens {tokens} per layer")
    if any(router) or any(tokens):
        raise AssertionError(f"{label} step {i}: remat's recomputation "
                             f"selected other experts or tokens than the "
                             f"forward")
    return {"dropped": drops, "router_moved": router, "tokens_moved": tokens}


def f32_step(torch, cfg, params, batch, card) -> dict:
    """Step 1 forward and backward (no AdamW) of ``cfg`` with ``params``
    cast to f32: its loss and gradient norm, to hold the bf16 step's
    against."""
    from repro_torch import pytree
    from repro_torch.optim import adam
    from repro_torch.train import steps as TS
    cfg32 = dataclasses.replace(cfg, param_dtype="float32")
    p32 = pytree.tree_map(lambda x: x.float(), params)
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    loss, _, grads = TS.value_and_grad(TS.make_loss_fn(cfg32),
                                       remat=cfg.remat)(p32, batch)
    gnorm = adam.global_norm(grads)
    end.record()
    torch.cuda.synchronize()
    row = {"loss": loss.item(), "grad_norm": gnorm.item(),
           "ms": start.elapsed_time(end),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"[train {cfg.name} f32] step 1 forward and backward in f32 (no "
        f"AdamW; {tree_bytes(p32) / 1e9:.3f} GB of weights) on {card}: loss "
        f"{row['loss']:.6f} grad_norm {row['grad_norm']:.6f} "
        f"{row['ms']:.3f} ms, peak {row['peak_gb']:.2f} GB")
    del p32, grads
    torch.cuda.empty_cache()
    return row


def moved(a, b, tokens: int) -> int:
    """Of two (B, E, C) capacity selections over ``tokens`` tokens, the
    tokens that one run's experts took and the other's did not."""
    import torch
    def mask(idx):
        return torch.zeros((*idx.shape[:-1], tokens), dtype=torch.bool,
                           device=idx.device).scatter_(-1, idx, True)
    return int((mask(a) & ~mask(b)).sum())


def drive_moe(torch, name, counters, card, full_jobs, jobs) -> dict:
    """Plan and serve one MoE model: the full-depth plans, then prefill
    and decode of the model cut to ``MOE_DEPTH[name]`` layers at full
    width through the 1x1 plans of the cut model's own steps; returns
    its attention launches in the captured prefill requests (replays
    times the launches the capture recorded) and the arctic-shape
    sites' errors.

    Args:
        name: ``mixtral_8x22b`` or ``arctic_480b``.
        counters: kernel name -> its wrapper module (``launches``).
        card: the card's name and power limit, for the time lines.
        full_jobs: the :func:`plan_job` results of its full-depth
            prefill and decode steps, by kind (their 2x4 plans are
            reported).
        jobs: the same for the cut model (their 1x1 plans run it).
    """
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.train.steps import make_prefill_step

    t_start = time.perf_counter()
    full = dataclasses.replace(get_config(name), use_pallas=True)
    B, S = MOE_SHAPE
    for kind, job in full_jobs.items():
        plan = plan_of(job, "2x4")
        specs = {p.rsplit("[", 1)[1].strip("]'"): tuple(s) for p, s in
                 zip(plan.input_paths, plan.in_specs)
                 if "['ffn']" in p and p.endswith(
                     ("['wi']", "['wgate']", "['wo']", "['wg']"))}
        st = job["stats"]
        log(f"[moe plan {name} {kind} 2x4] {full.num_layers} layers: "
            f"{job['seconds']:.3f} s to the plans in the worker process "
            f"(trace {st['phases']['trace']:.3f} s, search "
            f"{plan.search_seconds:.3f} s), {st['ops']} ops, "
            f"{st['colors']} colors, {st['conflicts']} conflicts, cost "
            f"{plan.cost:.6f}, expert weights {json.dumps(specs)}, rules "
            f"{json.dumps(plan.logical_rules)}, json round-trip ok")

    cfg = dataclasses.replace(full, num_layers=MOE_DEPTH[name])
    per_request = sum(T.kernel_sites(cfg)["flash_attention"]) * \
        cfg.num_layers
    plan1 = plan_of(jobs["prefill"], "1x1")
    sites = {r["site"]: r["impl"] for r in plan1.kernel_sites}
    if sites != ({"flash_attention:0": "cuda"} if per_request else {}):
        raise AssertionError(f"{name} 1x1 plan kernel sites chose {sites}")
    st = jobs["prefill"]["stats"]
    log(f"[partition {name} 1x1] the {cfg.num_layers}-layer prefill step "
        f"traced in the worker process ({st['ops']} ops, trip counts "
        f"{st['trips']}, {jobs['prefill']['seconds']:.3f} s to its "
        f"plans): cost={plan1.cost:.6f} sites={json.dumps(sites)}")
    step = make_prefill_step(cfg)
    applied = plan1.apply(step)
    eager = plan1.apply(step, capture=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    log(f"[moe {name}] {cfg.num_layers} of {full.num_layers} layers at "
        f"full width: {tree_bytes(params) / 1e9:.3f} GB of bf16 weights "
        f"made in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_reserved() / 1e9:.3f} GB reserved")
    tgen = torch.Generator(device="cuda").manual_seed(1)
    requests = [{"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                         generator=tgen, device="cuda",
                                         dtype=torch.int32)}
                for _ in range(REQUESTS)]
    eager(params, requests[0])              # warm-up, not counted
    graph = capture_once(torch, applied, f"{name} prefill B={B} S={S}",
                         params, requests[0])
    if graph.launches["flash_attention"] != per_request or \
            graph.launches["rg_lru"]:
        raise AssertionError(f"{name}: the graph recorded launches "
                             f"{graph.launches}; expected {per_request} "
                             f"flash_attention")

    for mod in counters.values():
        mod.launches = 0
    replays = applied.replays
    outs = {"captured": [], "eager": []}
    times = {"captured": [], "eager": []}
    for i, req in enumerate(requests):
        order = ("captured", "eager") if i % 2 == 0 else ("eager", "captured")
        for label in order:
            fn = applied if label == "captured" else eager
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            logits = fn(params, req)
            end.record()
            torch.cuda.synchronize()
            if logits.shape != (B, cfg.vocab_size) or \
                    not torch.isfinite(logits).all():
                raise AssertionError(f"{name} {label} request {i}: logits "
                                     f"not finite or misshapen")
            times[label].append(start.elapsed_time(end))
            outs[label].append(logits.float())
            log(f"[serve {name} {label}] request {i}: next tokens "
                f"{logits.float().argmax(-1).tolist()} prefill "
                f"{times[label][-1]:.3f} ms, peak "
                f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, reserved "
                f"{torch.cuda.memory_reserved() / 1e9:.2f} GB")
    launches = graph_launches(counters, applied, replays)
    captured = (applied.replays - replays) * \
        graph.launches["flash_attention"]
    want = {"flash_attention": 2 * per_request * REQUESTS, "rg_lru": 0}
    if {k: launches[k] for k in want} != want:
        raise AssertionError(f"{name}: kernel launches {launches}, expected "
                             f"{want}")
    if applied.captures != 1 or applied.replays - replays != REQUESTS:
        raise AssertionError(f"{name}: {applied.captures} captures, "
                             f"{applied.replays - replays} replays")
    for i, (a, b) in enumerate(zip(outs["captured"], outs["eager"])):
        if not torch.equal(a, b):
            raise AssertionError(f"{name} request {i}: captured and eager "
                                 f"logits differ, max|diff| "
                                 f"{(a - b).abs().max().item():.3e}")
        log(f"[serve {name}] request {i}: captured logits equal eager bit "
            f"for bit")
    log(f"[moe {name}] kernel launches on the prefill path: "
        f"{json.dumps({k: launches[k] for k in want})} = {per_request} x "
        f"{REQUESTS} captured + {per_request} x {REQUESTS} eager")
    log(f"[prefill time] {card}: {name} ({cfg.num_layers} layers) B={B} "
        f"S={S} per request, captured {fmt_ms(times['captured'])} (median "
        f"{percentile(times['captured'], 0.5):.3f}), eager "
        f"{fmt_ms(times['eager'])} (median "
        f"{percentile(times['eager'], 0.5):.3f}); capture "
        f"{graph.seconds:.3f} s, graph pool {graph.pool_bytes / 1e9:.3f} GB")
    del graph
    applied.release()
    del applied

    # the routed tokens each request lost to capacity, and for arctic
    # the attention sites at the model's own q, k, v and the logits
    # through the plain version
    kernel_run, site_errs = [], []
    sites_qkv = []
    real_attention = ops.attention

    def recorded(q, k, v, *, causal=True):
        sites_qkv.append((q, k, v, causal))
        return real_attention(q, k, v, causal=causal)

    for i, req in enumerate(requests):
        ops.attention = recorded if i == 0 else real_attention
        try:
            with MoESelections() as sel:
                logits = eager(params, req).float()
        finally:
            ops.attention = real_attention
        if not torch.equal(logits, outs["eager"][i]):
            raise AssertionError(f"{name} request {i}: a recorded eager run "
                                 f"differs from the eager run")
        kernel_run.append(sel.selected())
        log(f"[moe {name}] request {i}: routed tokens dropped per layer and "
            f"row {sel.drops().tolist()} (capacity "
            f"{sel.calls[1][2].shape[-1]} of {S} a row and expert)")
    for j, (q, k, v, causal) in enumerate(sites_qkv):
        got = fa.flash_attention(q, k, v, causal=causal)
        want_o = fa.reference(q, k, v, causal=causal)
        err = (got.float() - want_o.float()).abs().max().item()
        torch.testing.assert_close(got.float(), want_o.float(),
                                   rtol=FA_TOL["bfloat16"],
                                   atol=FA_TOL["bfloat16"])
        site_errs.append(err)
        log(f"[kernel] flash_attention at {name}'s layer {j} site, its own "
            f"q {tuple(q.shape)} k {tuple(k.shape)} bf16 (GQA "
            f"{cfg.num_heads // cfg.num_kv_heads}): max|err|={err:.3e} "
            f"(tol {FA_TOL['bfloat16']}) ok")
    del sites_qkv
    if per_request:
        plain = dataclasses.replace(
            plan1, kernel_sites=[{**r, "impl": "ref"}
                                 for r in plan1.kernel_sites]).apply(
                                     step, capture=False)
        before = {k: mod.launches for k, mod in counters.items()}
        for i, req in enumerate(requests):
            with MoESelections() as sel:
                b = plain(params, req).float()
            a = outs["captured"][i]
            flips = [moved(x, y, S) for x, y in
                     zip(kernel_run[i], sel.selected())]
            rel = ((a - b).abs().max() / b.abs().max()).item()
            agree = (a.argmax(-1) == b.argmax(-1)).sum().item()
            log(f"[serve {name}] request {i}: max|kernel-plain|/max|plain| "
                f"= {rel:.3e} (tol {LOGITS_REL_TOL}), argmax agree "
                f"{agree}/{B}; tokens in one run's capacity selection "
                f"and not the other's, per layer: {flips} of "
                f"{kernel_run[i][0].numel()} selected")
            if rel > LOGITS_REL_TOL:
                raise AssertionError("kernel and plain logits disagree")
        if {k: mod.launches for k, mod in counters.items()} != before:
            raise AssertionError("the plain path launched a kernel")
    del eager, outs
    torch.cuda.empty_cache()

    drive_decode(torch, cfg, params, counters, card, jobs["decode"])
    del params
    torch.cuda.empty_cache()
    log(f"[elapsed] {name} MoE phase {time.perf_counter() - t_start:.1f} s")
    return {"launches": captured, "site_errs": site_errs}


def place_in_place(applied, params, prefix: str = "[0][0]") -> None:
    """Place ``params`` (the first argument of ``applied``'s step, or the
    subtree of it at ``prefix``) as the plan's ``in_specs``, leaf by
    leaf, in its dicts: each entry is rebound to its block as soon as
    the block is made, so the full leaf is freed then (a full-width
    arctic layer, held whole and placed at once by two ranks on one
    card, would not fit)."""
    import torch
    from torch.distributed.tensor import distribute_tensor
    mesh = applied.mesh
    placements = dict(zip(applied.plan.input_paths,
                          applied.plan.torch_in_placements(mesh)))

    def walk(node, path):
        keys = node.keys() if isinstance(node, dict) else range(len(node))
        for k in list(keys):
            p = f"{path}[{k!r}]"
            v = node[k]
            if not isinstance(v, torch.Tensor):
                walk(v, p)
                continue
            d = distribute_tensor(v, mesh, placements[p], src_data_rank=None)
            if d.to_local().untyped_storage().data_ptr() == \
                    v.untyped_storage().data_ptr():
                d = d.clone()
            del v
            node[k] = d
    walk(params, prefix)


def expert_stack_gathers(shapes, cfg) -> dict:
    """The all-gathers among ``collective_tally`` shapes whose result is
    a whole expert stack, (E, d, f) or (E, f, d), on any dim."""
    from repro_torch.launch.mesh import gathered_shapes
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    return {str(k): n for k, n in shapes.items()
            if k[0].startswith("all_gather") and any(
                len(g) >= 3 and g[-3:] in ((e, d, f), (e, f, d))
                for g in gathered_shapes(k[1]))}


def moe_mesh_rank(rank, jobs, n_requests):
    """One of the two ranks that share card 0 in the MoE mesh phase.

    For each cut model (``jobs``: name -> (depth, its ``"mesh"``
    :func:`plan_job` plans)): apply the (1, 2) prefill plan to the
    seeded weights, placed leaf by leaf, answer ``n_requests`` requests
    (each timed on the host clock with the card synchronized, under
    ``CommDebugMode`` and the collective tally, its capacity selections
    recorded); free them; then make the same weights again and serve one
    ``MESH_SERVE`` request through the serving launcher's route on the
    mesh (``serve.serve_replicated``: the weights, cache and prompts
    replicated, the decode plan's rules).  Returns, per model, the
    gathered logits, tokens and selections and what the rank counted."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.configs import get_config
    from repro_torch.core.partitioner import ShardingPlan
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as M
    from repro_torch.launch import serve
    from repro_torch.models import sharding
    from repro_torch.models import transformer as T
    from repro_torch.train.steps import make_decode_step, make_prefill_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for name, (depth, plans) in jobs.items():
        cfg = dataclasses.replace(get_config(name), use_pallas=True,
                                  num_layers=depth)
        B, S = MOE_SHAPE
        applied = ShardingPlan.from_json(plans["1x2"]).apply(
            make_prefill_step(cfg))
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = T.init_params(cfg,
                               torch.Generator(device="cuda").manual_seed(0))
        place_in_place(applied, params)
        torch.cuda.synchronize()
        place_s = time.perf_counter() - t0
        tgen = torch.Generator(device="cuda").manual_seed(1)
        requests = [{"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                             generator=tgen, device="cuda",
                                             dtype=torch.int32)}
                    for _ in range(n_requests)]
        fa.launches = 0
        ops.local_calls.clear()
        sharding.per_shard.clear()
        ms, logits, selected = [], [], []
        comm_counts, calls, nbytes, comm_s, shapes = (
            collections.Counter() for _ in range(5))
        for req in requests:
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with CommDebugMode() as comm, M.collective_tally() as tally, \
                    MoESelections() as sel:
                y = applied(params, req)
                torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            comm_counts.update({str(k): v for k, v in
                                comm.get_comm_counts().items()})
            calls.update(tally.calls)
            nbytes.update(tally.bytes)
            comm_s.update(tally.seconds)
            shapes.update(tally.shapes)
            logits.append(y.full_tensor().float().cpu())
            selected.append([x.full_tensor().cpu() for x in sel.selected()])
            del sel
        res = {"logits": logits, "ms": ms, "place_s": place_s,
               "selected": selected, "comm_counts": dict(comm_counts),
               "calls": dict(calls), "bytes": dict(nbytes),
               "comm_s": dict(comm_s),
               "expert_gathers": expert_stack_gathers(shapes, cfg),
               "launches": fa.launches,
               "local_calls": [[k, impl, shp, n] for (k, impl, shp, _), n
                               in ops.local_calls.items()],
               "per_shard": dict(sharding.per_shard),
               "prefill_peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        del params, applied, requests, y
        torch.cuda.empty_cache()

        # decode through the serving launcher's route on the mesh
        dplan = ShardingPlan.from_json(plans["decode 1x2"])
        mesh = M.build_mesh(dplan.mesh, "cuda")
        Bd, P, G = MESH_SERVE
        torch.cuda.reset_peak_memory_stats()
        params = T.init_params(cfg,
                               torch.Generator(device="cuda").manual_seed(0))
        prompts = torch.randint(0, cfg.vocab_size, (Bd, P), device="cuda",
                                generator=torch.Generator(
                                    device="cuda").manual_seed(2),
                                dtype=torch.int32)
        dist.barrier()
        t0 = time.perf_counter()
        with M.collective_tally() as tally:
            served = serve.serve_replicated(
                make_decode_step(cfg), params,
                T.init_cache(cfg, Bd, P + G), prompts, G,
                dict(dplan.logical_rules), mesh)
        res["serve"] = {
            "s": time.perf_counter() - t0, "rules": dplan.logical_rules,
            "tokens": served.tokens.full_tensor().cpu(),
            "prompt_logits": served.prompt_logits.full_tensor().float().cpu(),
            "prefill_ms": served.prefill_ms, "step_ms": served.step_ms,
            "calls": dict(tally.calls), "bytes": dict(tally.bytes),
            "steps": P + G - 1,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        out[name] = res
        del params, served, prompts
        torch.cuda.empty_cache()
    return out


def drive_moe_mesh(torch, counters, card, jobs) -> dict:
    """The MoE mesh phase (7c): both MoE models, cut to
    ``MOE_MESH_DEPTH``, on two ranks of one gloo group sharing card 0.

    One card first: each cut model's 1x1 prefill plan (eager) answers the
    requests the ranks will answer, with its capacity selections
    recorded, and ``serve_loop`` serves the ``MESH_SERVE`` request; each
    model is freed before the next.  Then the ranks (:func:`moe_mesh_rank`)
    answer the same requests on the (1, 2) plan and serve the same
    request through the launcher's route.  Their gathered last-token
    logits must lie within ``LOGITS_REL_TOL`` of the largest of one
    card's, and the served prompt logits too, with argmax equal but in a
    tie (a row whose one-card top two logits lie within twice the
    largest difference); arctic's
    attention sites launch the kernel once a layer and request on each
    rank; no expert stack is gathered whole.

    Args:
        counters: kernel name -> its wrapper module (``launches``).
        card: the card's name and power limit, for the time lines.
        jobs: model name -> its ``"mesh"`` :func:`plan_job` result.

    Returns:
        Model name -> each rank's attention launches.
    """
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models import transformer as T
    from repro_torch.train.steps import make_decode_step, make_prefill_step

    t_start = time.perf_counter()
    B, S = MOE_SHAPE
    Bd, P, G = MESH_SERVE
    one = {}
    for name, depth in MOE_MESH_DEPTH.items():
        job = jobs[name]
        cfg = dataclasses.replace(get_config(name), use_pallas=True,
                                  num_layers=depth)
        plan2, dplan = plan_of(job, "1x2"), plan_of(job, "decode 1x2")
        experts = {p.rsplit("[", 1)[1].strip("]'"): tuple(s) for p, s in
                   zip(plan2.input_paths, plan2.in_specs)
                   if "['ffn']" in p and p.endswith(
                       ("['wi']", "['wgate']", "['wo']", "['wg']"))}
        sites = {r["site"]: str(tuple(r["in_specs"][0]))
                 for r in plan2.kernel_sites if r["sharded"]}
        tokens = tuple(plan2.in_specs[plan2.input_paths.index(
            "[0][1]['tokens']")])
        log(f"[moe mesh plan {name} 1x2] {depth} layers, traced in the "
            f"worker process: {job['stats']['conflicts']} conflicts, cost "
            f"{plan2.cost:.6f}, comm_bytes "
            f"{plan2.breakdown['comm_bytes']:.0f}, tokens {tokens}, "
            f"expert weights {json.dumps(experts)}, sharded kernel sites "
            f"{json.dumps(sites)}; decode plan ({job['decode conflicts']} "
            f"conflicts) rules {json.dumps(dplan.logical_rules)}")
        # one card: the same requests on the 1x1 plan, the same request
        # served by serve_loop
        step = make_prefill_step(cfg)
        eager = plan_of(job, "1x1").apply(step, capture=False)
        params = T.init_params(cfg,
                               torch.Generator(device="cuda").manual_seed(0))
        tgen = torch.Generator(device="cuda").manual_seed(1)
        logits, selected = [], []
        for _ in range(MOE_MESH_REQUESTS):
            req = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                           generator=tgen, device="cuda",
                                           dtype=torch.int32)}
            with MoESelections() as sel:
                logits.append(eager(params, req).float().cpu())
            selected.append([x.cpu() for x in sel.selected()])
            del sel
        prompts = torch.randint(0, cfg.vocab_size, (Bd, P), device="cuda",
                                generator=torch.Generator(
                                    device="cuda").manual_seed(2),
                                dtype=torch.int32)
        served = serve.serve_loop(make_decode_step(cfg), params,
                                  T.init_cache(cfg, Bd, P + G), prompts, G)
        one[name] = {"logits": logits, "selected": selected,
                     "tokens": served.tokens.cpu(),
                     "prompt_logits": served.prompt_logits.float().cpu(),
                     "step_ms": served.step_ms}
        del params, eager, served, prompts
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    log(f"[moe mesh] before the ranks the parent holds "
        f"{torch.cuda.memory_reserved() / 1e9:.3f} GB reserved, "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB allocated")
    t0 = time.perf_counter()
    ranks = run_ranks(
        moe_mesh_rank, 2,
        {name: (depth, jobs[name]["plans"])
         for name, depth in MOE_MESH_DEPTH.items()},
        MOE_MESH_REQUESTS, timeout=MOE_MESH_TIMEOUT)
    wall = time.perf_counter() - t0
    launches = {}
    for name, depth in MOE_MESH_DEPTH.items():
        cfg = dataclasses.replace(get_config(name), num_layers=depth)
        want_launches = sum(T.kernel_sites(cfg)["flash_attention"]) * \
            depth * MOE_MESH_REQUESTS
        for rank, res in enumerate(r[name] for r in ranks):
            sv = res["serve"]
            log(f"[moe mesh {name} rank {rank}] flash_attention launches "
                f"{res['launches']} (expected {want_launches}), local sites "
                + json.dumps(res["local_calls"]) + ", ops per shard "
                + json.dumps(res["per_shard"]))
            log(f"[moe mesh {name} rank {rank}] prefill collectives per "
                f"{MOE_MESH_REQUESTS} requests: CommDebugMode "
                + json.dumps(res["comm_counts"]) + ", result bytes by kind "
                + json.dumps(res["bytes"]) + ", host s in them and their "
                "waits " + json.dumps({k: round(v, 3) for k, v in
                                       res["comm_s"].items()})
                + ", expert stacks gathered whole "
                + json.dumps(res["expert_gathers"]))
            log(f"[moe mesh time] {card}: {name} ({depth} layers) rank "
                f"{rank} per request {fmt_ms(res['ms'])} (host clock, card "
                f"synchronized; two ranks time-sharing one H100 over gloo: "
                f"not a multi-card figure); place {res['place_s']:.3f} s; "
                f"peak {res['prefill_peak_gb']:.2f} GB")
            log(f"[moe mesh serve {name} rank {rank}] {card}: rules "
                f"{json.dumps(sv['rules'])}; {sv['steps']} decode steps: "
                f"prompt {sv['prefill_ms']:.1f} ms, median "
                f"{percentile(sv['step_ms'], 0.5):.2f} ms per generated "
                f"token (CUDA events on the rank; one card's serve_loop "
                f"{percentile(one[name]['step_ms'], 0.5):.2f}); collectives "
                + json.dumps(sv["calls"]) + ", bytes "
                + json.dumps(sv["bytes"]) + f"; peak {sv['peak_gb']:.2f} GB; "
                f"{sv['s']:.1f} s")
            if res["launches"] != want_launches:
                raise AssertionError(f"{name} rank {rank}: attention "
                                     f"launches {res['launches']}, expected "
                                     f"{want_launches}")
            if res["expert_gathers"]:
                raise AssertionError(f"{name} rank {rank}: expert stacks "
                                     f"gathered whole")
            if not all(torch.isfinite(x).all() for x in res["logits"]):
                raise AssertionError(f"{name} rank {rank}: logits not "
                                     f"finite")
        for key in ("logits",):
            for a, b in zip(ranks[0][name][key], ranks[1][name][key]):
                if not torch.equal(a, b):
                    raise AssertionError(f"{name}: the ranks gathered "
                                         f"different {key}")
        res = ranks[0][name]
        for i, (got, want) in enumerate(zip(res["logits"],
                                            one[name]["logits"])):
            rel = ((got - want).abs().max() / want.abs().max()).item()
            agree = (got.argmax(-1) == want.argmax(-1)).sum().item()
            flips = [moved(a, b, S) for a, b in
                     zip(res["selected"][i], one[name]["selected"][i])]
            log(f"[moe mesh {name}] request {i}: 1x2 on two ranks vs 1x1 "
                f"on one card: max|diff|/max|1x1| = {rel:.3e} (tol "
                f"{LOGITS_REL_TOL}), argmax agree {agree}/{B}; tokens in one "
                f"run's capacity selection and not the other's, per layer: "
                f"{flips} of {res['selected'][i][0].numel()} selected")
            if rel > LOGITS_REL_TOL:
                raise AssertionError(f"{name}: mesh and one-card logits "
                                     f"disagree")
        sv, ref = res["serve"], one[name]
        got_l, want_l = sv["prompt_logits"], ref["prompt_logits"]
        diff = (got_l - want_l).abs().max().item()
        rel = diff / want_l.abs().max().item()
        # a row whose argmax differs must be a tie: its top two logits on
        # one card within twice the largest difference, which bf16 sums
        # in another order may break either way
        top2 = want_l.topk(2, -1).values
        margin = (top2[..., 0] - top2[..., 1]).flatten()
        flipped = (got_l.argmax(-1) != want_l.argmax(-1)).flatten()
        ties = {int(b): round(margin[b].item(), 5)
                for b in flipped.nonzero().flatten()}
        agree = (sv["tokens"] == ref["tokens"]).float().mean().item()
        log(f"[moe mesh serve {name}] {card}: the launcher's route on two "
            f"ranks vs one card's serve_loop: prompt logits max|diff|/max "
            f"{rel:.3e} (tol {LOGITS_REL_TOL}), argmax equal in "
            f"{Bd - len(ties)}/{Bd} rows"
            + (f" (rows that differ, each with its one-card top-two margin, "
               f"a tie below 2 x max|diff| = {2 * diff:.5f}: "
               f"{json.dumps(ties)})" if ties else "")
            + f", generated tokens equal {agree:.0%}")
        if rel > LOGITS_REL_TOL or any(m > 2 * diff for m in ties.values()):
            raise AssertionError(f"{name}: mesh and one-card serve "
                                 f"disagree")
        launches[name] = [r[name]["launches"] for r in ranks]
    log(f"[moe mesh] two ranks, both models: {wall:.1f} s wall, the ranks' "
        f"start included")
    log(f"[elapsed] MoE mesh phase {time.perf_counter() - t_start:.1f} s")
    return launches


def drive_moe_train(torch, name, counters, card, seed: int, full_job,
                    job) -> dict:
    """Train one MoE model at full width, cut to ``MOE_TRAIN_DEPTH[name]``
    layers, through :func:`drive_train` (``moe=True``); report the 2x4
    plan of its full-depth train step.

    Args:
        full_job: the :func:`plan_job` result of the full-depth train
            step (its 2x4 plan is reported).
        job: the same for the cut step (its 1x1 plan runs it).
    """
    from repro_torch.configs import get_config
    t_start = time.perf_counter()
    full = dataclasses.replace(get_config(name), use_pallas=True)
    B, S = MOE_TRAIN_SHAPE
    plan = plan_of(full_job, "2x4")
    specs = {p.split(".", 1)[1].split("['layers']")[0] + "." +
             p.rsplit("[", 1)[1].strip("]'"): tuple(s)
             for p, s in zip(plan.input_paths, plan.in_specs)
             if "['ffn']" in p and p.endswith(("['wi']", "['wg']"))}
    st = full_job["stats"]
    log(f"[moe train plan {name} 2x4] {full.num_layers} layers, B={B} "
        f"S={S}: {full_job['seconds']:.3f} s to the plans in the worker "
        f"process (trace {st['phases']['trace']:.3f} s, search "
        f"{plan.search_seconds:.3f} s), {st['ops']} ops, trip counts "
        f"{st['trips']}, {st['colors']} colors, {st['conflicts']} "
        f"conflicts, cost {plan.cost:.6f}, expert and router weights "
        f"{json.dumps(specs)}, rules {json.dumps(plan.logical_rules)}, "
        f"json round-trip ok")
    cfg = dataclasses.replace(full, num_layers=MOE_TRAIN_DEPTH[name])
    out = drive_train(torch, cfg, counters, card, seed, MOE_TRAIN_SHAPE,
                      HYBRID_TRAIN_OPT, job, moe=True)
    out["seconds"] = time.perf_counter() - t_start
    log(f"[elapsed] {name} MoE train phase {out['seconds']:.1f} s")
    return out


def stacked(path: str) -> bool:
    """Whether the parameter at ``path`` stacks its layers on its leading
    dim (the decoder's layer scan's, or an encoder's)."""
    return "['layers']" in path or "['enc_layers']" in path


def plan_splits(plan) -> dict:
    """The parameters a (1, 2) plan shards on its ``model`` axis: each
    leaf's path (as ``pytree.flatten_with_paths`` of the parameters gives
    it) -> the sharded dim of the weight each layer takes (a stacked
    leaf's layer dim left out; a leaf sharded on its layer dim is left
    out too: its layer is handed whole to both ranks)."""
    out = {}
    for path, spec in zip(plan.input_paths, plan.in_specs):
        if not path.startswith("[0][0].params"):
            continue
        on = [k for k, s in enumerate(spec) if s == "model" or (
            isinstance(s, (tuple, list)) and "model" in s)]
        path = path[len("[0][0].params"):]
        k = on[0] - stacked(path) if len(on) == 1 else -1
        if k >= 0:
            out[path] = k
    return out


@contextlib.contextmanager
def split_products(params, splits: dict):
    """Each product of the model whose weight the plan shards on a dim
    the product contracts, taken as the sum of that contraction's two
    halves, each half rounded to the product's dtype first: what two
    ranks compute when each takes its half and the pending sum is
    reduced.  Other products run as they are.

    ``params``: the step's parameters; ``splits``: :func:`plan_splits`.
    A weight is known by its storage (each layer of a stacked leaf by its
    own); the products are ``matmul`` and ``einsum`` of
    ``models.layers`` and ``matmul`` of ``models.transformer``, swapped
    while the context is open (as :class:`MoESelections` swaps
    ``top_k``), the recomputation of remat included.
    """
    import torch

    from repro_torch import pytree
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    at = {}
    for x, path in zip(*pytree.flatten_with_paths(params)):
        if path in splits:
            for w in (x.unbind(0) if stacked(path) else (x,)):
                at[w.data_ptr()] = splits[path]
    saved = L.matmul, L.einsum, T.matmul

    def matmul(x, w):
        if at.get(w.data_ptr()) != w.ndim - 2:
            return saved[0](x, w)
        h = w.shape[-2] // 2
        return x[..., :h] @ w[..., :h, :] + x[..., h:] @ w[..., h:, :]

    def einsum(eq, *ops):
        ins, out = eq.replace(" ", "").split("->")
        specs = ins.split(",")
        c = next((sp[at[o.data_ptr()]] for o, sp in zip(ops, specs)
                  if o.data_ptr() in at and sp[at[o.data_ptr()]] not in out),
                 None)
        if c is None:
            return saved[1](eq, *ops)
        n = next(o.shape[sp.index(c)] for o, sp in zip(ops, specs)
                 if c in sp)
        return sum(torch.einsum(eq, *[
            o.narrow(sp.index(c), a, m) if c in sp else o
            for o, sp in zip(ops, specs)])
            for a, m in ((0, n // 2), (n // 2, n - n // 2)))
    L.matmul, L.einsum, T.matmul = matmul, einsum, matmul
    try:
        yield
    finally:
        L.matmul, L.einsum, T.matmul = saved


def regrouped_step(cfg, opt, splits: dict, accum_steps: int = 1):
    """``make_train_step``'s step with the products the plan splits
    between the two ranks regrouped as they regroup them
    (:func:`split_products`), in ``accum_steps`` microbatches (a plan
    that splits the batch between the ranks sums its gradient's halves):
    the same math, rounded otherwise; its distance from the plain step's
    run bounds the two ranks' (7e, 7i)."""
    from repro_torch.train import steps as TS
    step = TS.make_train_step(cfg, opt, accum_steps)

    def run(state, batch):
        with split_products(state.params, splits):
            return step(state, batch)
    return run


def router_fault_step(cfg, opt, scale: float):
    """``make_train_step``'s loss, gradients and update with the router's
    gradient scaled by ``scale``: the planted fault phase 7e's leaf
    checks must see (AdamW's update is all but blind to the scale, so
    only the router's moments show it)."""
    from repro_torch import pytree
    from repro_torch.optim import adam
    from repro_torch.train import steps as TS
    grads_of = TS.value_and_grad(TS.make_loss_fn(cfg), remat=cfg.remat)

    def step(state, batch):
        loss, _, grads = grads_of(state.params, batch)
        leaves, paths = pytree.flatten_with_paths(grads)
        grads = pytree.unflatten(grads, [
            g * scale if p.endswith(ROUTER) else g
            for g, p in zip(leaves, paths)])
        params, opt_state, gnorm = adam.apply_updates(
            opt, state.opt, state.params, grads)
        return TS.TrainState(params, opt_state), {"loss": loss,
                                                  "grad_norm": gnorm}
    return step


def positives(t) -> int:
    """The entries of ``t`` above zero (a DTensor's, on every rank)."""
    n = (t > 0).sum()
    return int(n.full_tensor() if hasattr(n, "full_tensor") else n)


def local_selections(record) -> list:
    """``record``'s top-k calls (:class:`MoESelections`) on this rank's
    blocks: each input, values and indices as local tensors."""
    return [tuple(t.to_local() if hasattr(t, "to_local") else t
                  for t in call) for call in record.calls]


def moe_mesh_train_rank(rank, plan_json, depth, seed, out_dir):
    """One of the two ranks that share card 0 in the MoE mesh train phase
    (7e): make the seeded weights and place them leaf by leaf as the
    (1, 2) plan says, the moments as zeros in their own placements, then
    take ``MOE_MESH_TRAIN_STEPS`` steps through ``plan.apply(step,
    donate_argnums=0)`` on the fixed seeded batch, each timed on the
    host clock with the card synchronized, under the collective tally,
    its capacity selections recorded on this rank's blocks.  The final
    state's local blocks and their placements go to ``out_dir``.
    Returns what the rank counted, and the router's leaves after step 1
    (``first``)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor

    from repro_torch import pytree
    from repro_torch.configs import get_config
    from repro_torch.core.partitioner import ShardingPlan
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import mesh as M
    from repro_torch.models import transformer as T
    from repro_torch.optim import adam
    from repro_torch.optim.adam import AdamConfig
    from repro_torch.train import steps as TS

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = "mixtral_8x22b"
    cfg = dataclasses.replace(get_config(name), use_pallas=True,
                              num_layers=depth)
    opt = AdamConfig(**MOE_MESH_TRAIN_OPT)
    B, S = MOE_MESH_TRAIN_SHAPE
    applied = ShardingPlan.from_json(plan_json).apply(
        TS.make_train_step(cfg, opt), donate_argnums=0)
    mesh = applied.mesh
    placements = dict(zip(applied.plan.input_paths,
                          applied.plan.torch_in_placements(mesh)))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        seed))
    place_in_place(applied, params, "[0][0].params")
    leaves, paths = pytree.flatten_with_paths(params)
    dt = getattr(torch, opt.state_dtype)
    moments = {}
    for tree in ("m", "v"):
        moments[tree] = pytree.unflatten(params, [distribute_tensor(
            torch.zeros(x.shape, dtype=dt, device="cuda"), mesh,
            placements[f"[0][0].opt.{tree}{p}"], src_data_rank=None)
            for x, p in zip(leaves, paths)])
    step_count = distribute_tensor(
        torch.zeros((), dtype=torch.int32, device="cuda"), mesh,
        placements["[0][0].opt.step"], src_data_rank=None)
    state = TS.TrainState(params, adam.AdamState(step_count, moments["m"],
                                                 moments["v"]))
    tgen = torch.Generator(device="cuda").manual_seed(seed + 1)
    tokens = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=tgen,
                           device="cuda", dtype=torch.int32)
    batch = {k: distribute_tensor(v.contiguous(), mesh,
                                  placements[f"[0][1][{k!r}]"],
                                  src_data_rank=None)
             for k, v in (("tokens", tokens[:, :-1]),
                          ("targets", tokens[:, 1:]))}
    del params, leaves, moments, tokens
    torch.cuda.synchronize()
    place_s = time.perf_counter() - t0
    state_gb = sum(x.to_local().numel() * x.to_local().element_size()
                   for x in pytree.tree_leaves(state)) / 1e9
    fa.launches = 0
    rows, gathers = [], collections.Counter()
    for i in range(1, MOE_MESH_TRAIN_STEPS + 1):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with M.collective_tally() as tally, MoESelections() as record:
            state, m = applied(state, batch)
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        # the capacity selection's pool of tokens, whole on every rank,
        # and the routed pairs each layer's forward dropped (all ranks')
        pool = record.calls[1][0].shape[-1]
        dropped = [positives(x) - positives(w)
                   for x, w, _ in record.calls[1:2 * cfg.num_layers:2]]
        calls = local_selections(record)
        del record
        n = cfg.num_layers
        fwd = [calls[2 * j:2 * j + 2] for j in range(n)]
        again = [calls[2 * n + 2 * j:2 * n + 2 * j + 2]
                 for j in range(n)][::-1]
        gathers.update(expert_stack_gathers(tally.shapes, cfg))
        rows.append({
            "loss": m["loss"].full_tensor().item(),
            "grad_norm": m["grad_norm"].full_tensor().item(), "ms": ms,
            "calls": len(calls),
            "dropped": dropped,
            "router_moved": [int((f[0][2] != r[0][2]).sum())
                             for f, r in zip(fwd, again)],
            "tokens_moved": [moved(f[1][2], r[1][2], pool)
                             for f, r in zip(fwd, again)],
            "calls_by_kind": dict(tally.calls),
            "bytes": dict(tally.bytes),
            "comm_s": round(sum(tally.seconds.values()), 3)})
        del calls, fwd, again
        if i == 1:
            # the router's leaves after step 1, whole (outside the tally)
            first = {p: x.full_tensor().cpu() for x, p in
                     zip(*pytree.flatten_with_paths(state))
                     if p.endswith(ROUTER)}
    out = {"rows": rows, "place_s": place_s, "state_gb": state_gb,
           "first": first,
           "launches": fa.launches, "expert_gathers": dict(gathers),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "reserved_gb": torch.cuda.max_memory_reserved() / 1e9}
    leaves, paths = pytree.flatten_with_paths(state)
    t0 = time.perf_counter()
    torch.save({"paths": paths,
                "placements": [[("shard", p.dim) if type(p).__name__ ==
                                "Shard" else ("replicate",)
                                if p.is_replicate() else (str(p),)
                                for p in x.placements] for x in leaves],
                "locals": [x.to_local().cpu() for x in leaves]},
               os.path.join(out_dir, f"rank{rank}.pt"))
    out["save_s"] = time.perf_counter() - t0
    return out


def gathered_leaves(torch, out_dir, ranks: int):
    """The final state's leaves of :func:`moe_mesh_train_rank`, made
    whole on the host from the ranks' blocks ((1, 2) mesh: a shard on
    the model axis joined, a replica taken from rank 0): path -> leaf."""
    blocks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), mmap=True)
              for r in range(ranks)]
    out = {}
    for i, path in enumerate(blocks[0]["paths"]):
        data, model = blocks[0]["placements"][i]
        if data[0] != "replicate" or model[0] not in ("shard", "replicate"):
            raise AssertionError(f"{path}: placed {data}, {model}")
        out[path] = torch.cat([b["locals"][i] for b in blocks], model[1]) \
            if model[0] == "shard" else blocks[0]["locals"][i]
    return out


def leaf_apart(torch, got: dict, want: dict) -> dict:
    """Each leaf's |got - want| / |want| (norms, on the card)."""
    out = {}
    for p, w in want.items():
        a = got[p].to("cuda").double()
        b = w.to("cuda").double()
        out[p] = ((a - b).norm() / b.norm().clamp_min(1e-30)).item()
        del a, b
    return out


def beyond(far: dict, floor: dict) -> dict:
    """The leaves farther than their floor + ``TRAIN_REL_TOL``."""
    return {p: (far[p], floor[p]) for p in far
            if far[p] > floor[p] + TRAIN_REL_TOL}


def drive_moe_mesh_train(torch, card, seed: int, job) -> dict:
    """The MoE mesh train phase (7e): ``mixtral_8x22b`` at full width cut
    to ``MOE_MESH_TRAIN_DEPTH`` layers trained on two ranks of one gloo
    group sharing card 0, against one card.

    One card first, eagerly, from the seeded state and batch: the train
    step, ``MOE_MESH_TRAIN_STEPS`` steps (its final state kept on the
    host); the same steps with the products the plan splits regrouped as
    the two ranks regroup them (:func:`regrouped_step`), each leaf's
    relative distance from the first run's the regrouping floor (and the
    router's leaves' after step 1, their floor after one step); the same
    steps with the router's gradient scaled by ``ROUTER_FAULT``
    (:func:`router_fault_step`), a planted fault that must fail the leaf
    checks.  Then the ranks (:func:`moe_mesh_train_rank`) take the same
    steps through the (1, 2) plan.  Every loss and grad norm within
    ``TRAIN_REL_TOL`` of one card's, every leaf, and the router's leaves
    after step 1, within ``TRAIN_REL_TOL`` (relative, in norm) beyond
    their floor, the loss falling, no router pick or expert token chosen
    otherwise by remat's recomputation on either rank, and no expert
    stack, gradient or moment gathered whole.

    Args:
        card: the card's name and power limit, for the time lines.
        seed: the seed of the weights and the batch.
        job: the ``"mesh train"`` :func:`plan_job` result.

    Returns:
        Each rank's attention launches.
    """
    import tempfile

    from repro_torch import pytree
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.optim.adam import AdamConfig
    from repro_torch.train import steps as TS

    t_start = time.perf_counter()
    name, depth = next(iter(MOE_MESH_TRAIN_DEPTH.items()))
    cfg = dataclasses.replace(get_config(name), use_pallas=True,
                              num_layers=depth)
    B, S = MOE_MESH_TRAIN_SHAPE
    opt = AdamConfig(**MOE_MESH_TRAIN_OPT)
    plan = plan_of(job, "1x2")
    specs = {p.split(".", 1)[1].split("['layers']")[0] + "." +
             p.rsplit("[", 1)[1].strip("]'"): tuple(s)
             for p, s in zip(plan.input_paths, plan.in_specs)
             if "['ffn']" in p and p.endswith(("['wi']", "['wo']",
                                                "['wg']"))}
    tokens = tuple(plan.in_specs[plan.input_paths.index("[0][1]['tokens']")])
    st = job["stats"]
    log(f"[moe mesh train plan {name} 1x2] {depth} layer(s), B={B} S={S}, "
        f"hbm_per_chip {job['hbm'] / 1e9:.3f} GB (each rank's "
        f"share of the card): {job['seconds']:.3f} s to the plan in the "
        f"worker process, {st['ops']} ops, {st['conflicts']} conflicts, "
        f"cost {plan.cost:.6f}, predicted peak "
        f"{plan.breakdown['peak_bytes'] / 1e9:.3f} GB per device, tokens "
        f"{tokens}, expert and router weights {json.dumps(specs)}, rules "
        f"{json.dumps(plan.logical_rules)}")
    step = TS.make_train_step(cfg, opt)

    def run(fn, label):
        """``fn``'s steps from the seeded state and batch: the final
        state, each step's figures, the router's leaves after step 1."""
        state = TS.init_train_state(
            cfg, torch.Generator(device="cuda").manual_seed(seed), opt)
        tgen = torch.Generator(device="cuda").manual_seed(seed + 1)
        tok = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=tgen,
                            device="cuda", dtype=torch.int32)
        batch = {"tokens": tok[:, :-1].contiguous(),
                 "targets": tok[:, 1:].contiguous()}
        rows = []
        torch.cuda.reset_peak_memory_stats()
        for i in range(1, MOE_MESH_TRAIN_STEPS + 1):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, m = fn(state, batch)
            end.record()
            torch.cuda.synchronize()
            rows.append({"loss": m["loss"].item(),
                         "grad_norm": m["grad_norm"].item(),
                         "ms": start.elapsed_time(end)})
            if i == 1:
                first = {p: x.cpu() for x, p in
                         zip(*pytree.flatten_with_paths(state))
                         if p.endswith(ROUTER)}
        log(f"[moe mesh train {name} one card, {label}] {card}: losses "
            + json.dumps([round(r["loss"], 6) for r in rows])
            + ", grad norms "
            + json.dumps([round(r["grad_norm"], 6) for r in rows])
            + f", ms {fmt_ms([r['ms'] for r in rows])}, peak "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        return state, rows, first

    state, one, one_first = run(step, "eager")
    host = {p: x.cpu() for x, p in zip(*pytree.flatten_with_paths(state))}
    del state
    torch.cuda.empty_cache()
    splits = plan_splits(plan)
    log(f"[moe mesh train] products regrouped for the floor: those of "
        f"{json.dumps(splits)} (leaf -> the layer weight's dim the plan "
        f"shards on model)")
    floors = {}
    for label, fn in (
            ("floor", regrouped_step(cfg, opt, splits)),
            ("fault", router_fault_step(cfg, opt, ROUTER_FAULT))):
        state, _, first = run(fn, {
            "floor": "the plan's split products regrouped in halves",
            "fault": f"router gradient x{ROUTER_FAULT}, a planted fault"}[
                label])
        floors[label] = (leaf_apart(torch, {p: x for x, p in zip(
            *pytree.flatten_with_paths(state))}, host),
            leaf_apart(torch, first, one_first))
        del state
        torch.cuda.empty_cache()
    floor, floor1 = floors["floor"]
    caught = {**beyond(floors["fault"][0], floor),
              **{p + " (step 1)": v for p, v in
                 beyond(floors["fault"][1], floor1).items()}}
    log(f"[moe mesh train {name}] planted fault (router gradient "
        f"x{ROUTER_FAULT}) vs one card: "
        + ", ".join(f"{p} {d:.3e} (limit {f + TRAIN_REL_TOL:.3e})"
                    for p, (d, f) in caught.items())
        + f"; {len(caught)} leaves beyond their limit")
    if not caught:
        raise AssertionError("the leaf checks cannot see the planted "
                             "fault: floors too wide")
    log(f"[moe mesh train] before the ranks the parent holds "
        f"{torch.cuda.memory_reserved() / 1e9:.3f} GB reserved")
    with tempfile.TemporaryDirectory(prefix="moe-mesh-train-") as tmp:
        t0 = time.perf_counter()
        ranks = run_ranks(moe_mesh_train_rank, 2, job["plans"]["1x2"],
                          depth, seed, tmp, timeout=MOE_MESH_TRAIN_TIMEOUT)
        wall = time.perf_counter() - t0
        far = leaf_apart(torch, gathered_leaves(torch, tmp, 2), host)
        del host
        torch.cuda.empty_cache()
    far1 = leaf_apart(torch, ranks[0]["first"], one_first)
    for rank, res in enumerate(ranks):
        rows = res["rows"]
        log(f"[moe mesh train {name} rank {rank}] {card}: state "
            f"{res['state_gb']:.3f} GB placed in {res['place_s']:.3f} s, "
            f"flash_attention launches {res['launches']}, expert stacks "
            f"gathered whole {json.dumps(res['expert_gathers'])}, peak "
            f"{res['peak_gb']:.2f} GB, reserved {res['reserved_gb']:.2f} "
            f"GB, final blocks saved in {res['save_s']:.1f} s")
        for i, r in enumerate(rows, 1):
            log(f"[moe mesh train {name} rank {rank}] step {i}: loss "
                f"{r['loss']:.6f} grad_norm {r['grad_norm']:.6f} "
                f"{r['ms']:.1f} ms (host clock, card synchronized; two "
                f"ranks time-sharing one H100 over gloo: not a multi-card "
                f"figure); collectives {json.dumps(r['calls_by_kind'])}, "
                f"result bytes {json.dumps(r['bytes'])}, host s "
                f"{r['comm_s']}; routed pairs dropped to capacity per "
                f"layer {r['dropped']} of {cfg.experts_per_token * B * S}; "
                f"this rank's remat's "
                f"recomputation chose otherwise router picks "
                f"{r['router_moved']}, expert tokens {r['tokens_moved']}")
        if any(sum(r["router_moved"]) + sum(r["tokens_moved"])
               for r in rows) or any(
                   r["calls"] != 4 * depth for r in rows):
            raise AssertionError(f"rank {rank}: remat's recomputation "
                                 f"selected otherwise than the forward")
        if res["expert_gathers"]:
            raise AssertionError(f"rank {rank}: expert stacks gathered "
                                 f"whole")
        if res["launches"]:
            raise AssertionError(f"rank {rank}: the windowed attention "
                                 f"launched the kernel")
    rows = ranks[0]["rows"]
    for key in ("loss", "grad_norm"):
        worst = max(abs(r[key] - o[key]) / abs(o[key])
                    for r, o in zip(rows, one))
        log(f"[moe mesh train {name}] {key} per step on two ranks "
            + json.dumps([round(r[key], 6) for r in rows])
            + f" vs one card's, worst rel {worst:.3e} (tol {TRAIN_REL_TOL})")
        if worst > TRAIN_REL_TOL or any(
                r[key] != q[key] for r, q in zip(rows, ranks[1]["rows"])):
            raise AssertionError(f"two ranks' {key} disagree with one "
                                 f"card's or with each other")
    for label, keep in (("parameters", lambda p: p.startswith(".params")),
                        ("optimizer state",
                         lambda p: not p.startswith(".params"))):
        top = sorted((p for p in far if keep(p)), key=far.get,
                     reverse=True)[:3]
        log(f"[moe mesh train {name}] final {label} on two ranks vs one "
            f"card: worst |a-b|/|b| "
            + ", ".join(f"{p} {far[p]:.3e} (floor {floor[p]:.3e})"
                        for p in top)
            + f"; tol floor + {TRAIN_REL_TOL}")
    log(f"[moe mesh train {name}] router after step 1 on two ranks vs one "
        f"card: " + ", ".join(f"{p} {far1[p]:.3e} (floor {floor1[p]:.3e})"
                              for p in far1)
        + f"; tol floor + {TRAIN_REL_TOL}")
    worse = {**beyond(far, floor),
             **{p + " (step 1)": v for p, v in beyond(far1, floor1).items()}}
    if worse:
        raise AssertionError(f"leaves beyond the regrouping floor: {worse}")
    if not all(math.isfinite(r["loss"]) for r in rows) or \
            rows[-1]["loss"] >= rows[0]["loss"]:
        raise AssertionError(f"losses {[r['loss'] for r in rows]} not "
                             f"finite or not falling")
    med = percentile([r["ms"] for r in rows[1:]], 0.5)
    per_step = {k: sum(r["bytes"].get(k, 0) for r in rows[1:]) /
                (len(rows) - 1) for k in rows[-1]["bytes"]}
    log(f"[moe mesh train time] {card}: {name} ({depth} layer) B={B} "
        f"S={S}: steps 2-{MOE_MESH_TRAIN_STEPS} median {med:.1f} ms a rank "
        f"(step 1 {rows[0]['ms']:.1f}; one card eager "
        f"{percentile([o['ms'] for o in one[1:]], 0.5):.1f}); collectives "
        f"per step {sum(per_step.values()) / 1e9:.3f} GB "
        + json.dumps({k: round(v / 1e9, 4) for k, v in per_step.items()})
        + f"; peak {max(r['peak_gb'] for r in ranks):.2f} GB a rank vs "
        f"predicted {plan.breakdown['peak_bytes'] / 1e9:.2f} GB; "
        f"{wall:.1f} s wall for the ranks")
    log(f"[elapsed] MoE mesh train phase "
        f"{time.perf_counter() - t_start:.1f} s")
    return {name: [r["launches"] for r in ranks]}


def train_sites(cfg) -> dict:
    """Per kernel: its forward sites in the scanned period, in the tail,
    and its launches in one train step (the scanned ones again when
    remat recomputes the body)."""
    from repro_torch.models import transformer as T
    n = T.n_scan_blocks(cfg)
    return {k: {"period": p, "tail": t, "forward": n * p + t,
                "launches": n * p * (1 + cfg.remat) + t}
            for k, (p, t) in T.kernel_sites(cfg).items()}


def train_batch(torch, cfg, B: int, S: int, gen) -> dict:
    """A train batch of ``B`` x ``S`` positions as ``launch.specs`` lays it
    out (an encoder-decoder's frames, a vision model's patches, and the
    tokens), drawn on the card: the targets the tokens shifted by one."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.specs import batch_specs
    spec, _ = batch_specs(cfg, ShapeConfig("t", S, B, "train"))
    n = spec["tokens"].shape[1]
    tokens = torch.randint(0, cfg.vocab_size, (B, n + 1), generator=gen,
                           device="cuda", dtype=torch.int32)
    batch = {"tokens": tokens[:, :-1].contiguous(),
             "targets": tokens[:, 1:].contiguous()}
    for k, v in spec.items():
        if k not in batch:
            batch[k] = torch.randn(tuple(v.shape), generator=gen,
                                   device="cuda")
    return batch


def train_trips(cfg, S: int) -> list:
    """The trip counts of ``cfg``'s train program at ``S`` positions: the
    layer scans' (an encoder's too) and an sLSTM's time scan inside."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.specs import batch_specs
    from repro_torch.models import transformer as T
    n = T.n_scan_blocks(cfg)
    trips = {1, n} | ({cfg.encoder_layers} if cfg.encoder_layers else set())
    if "slstm" in T.block_kinds(cfg)[0]:
        spec, _ = batch_specs(cfg, ShapeConfig("t", S, 1, "train"))
        trips.add(n * spec["tokens"].shape[1])
    return sorted(trips)


def drive_train(torch, cfg, counters, card, seed: int, shape, opt_kw, job,
                small_layers=None, moe: bool = False,
                small_vs_cpu: bool = False) -> dict:
    """Plan and run the train step of ``cfg``; returns its launches.

    Args:
        cfg: the full-width model configuration (``use_pallas`` set).
        job: the :func:`plan_job` result of its train step (the session
            traced and the plans searched in the worker process).
        counters: kernel name -> its wrapper module (``launches``).
        card: the card's name and power limit, for the step lines.
        seed: the seed of the weights and the batch.
        shape: batch x tokens of the step.
        opt_kw: the ``AdamConfig`` fields.
        small_layers: the small f32 model's depth (``None``: the reduced
            config's), as its plan in ``job`` was traced.
        moe: an MoE model (no kernel site of its own): step 1 is held
            against the same step's loss and grad norm in f32 (forward
            and backward, no AdamW) instead of the plain sites' and the
            small model; each eager step's capacity selections are
            recorded, its routed pairs dropped printed per layer, and
            remat's recomputation must select what the forward did;
            captured and eager must agree bit for bit.
        small_vs_cpu: the small f32 model's step on the card (kernel
            sites) is also held against the same step on the CPU.
    """
    from repro_torch.configs import get_config
    from repro_torch import pytree
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.models.sharding import KernelDispatch, kernel_dispatch
    from repro_torch.optim.adam import AdamConfig
    from repro_torch.train import steps as TS

    B, S = shape
    name = cfg.name
    sites = train_sites(cfg)
    ran = [k for k, v in sites.items() if v["forward"]]
    opt = AdamConfig(**opt_kw)
    step = TS.make_train_step(cfg, opt)
    st = job["stats"]
    trips = st["trips"]
    log(f"[train session {name}] B={B} S={S} remat={cfg.remat}: "
        f"{st['ops']} ops, fingerprint {st['fingerprint']}, "
        f"trip counts {trips}, {st['colors']} colors, "
        f"{st['conflicts']} conflicts, kernel ops {st['kernel_ops']}, "
        f"phases " + json.dumps(st["phases"]) + " (worker process)")
    if trips != train_trips(cfg, S):
        raise AssertionError(f"train program trip counts {trips}, "
                             f"expected {train_trips(cfg, S)}")
    plan8 = plan_of(job, "2x4")
    log(f"[train partition {name} 2x4] cost={plan8.cost:.6f} "
        f"kernel_sites={len(plan8.kernel_sites)} "
        f"search={plan8.search_seconds:.3f} s "
        f"evaluations={plan8.evaluations} json round-trip ok")
    plan1 = plan_of(job, "1x1")
    got_sites = {r["site"]: r["impl"] for r in plan1.kernel_sites}
    # the period's sites, the tail's, then the period's recomputed
    want_sites = {f"{k}:{i}": "cuda" for k, v in sites.items()
                  for i in range(v["period"] * (1 + cfg.remat) + v["tail"])}
    if got_sites != want_sites:
        raise AssertionError(f"train 1x1 plan kernel sites chose "
                             f"{got_sites}, expected {want_sites}")
    log(f"[train partition {name} 1x1] cost={plan1.cost:.6f} sites="
        + json.dumps(got_sites))
    # captured with the state donated (the graph writes each new state
    # into the old one's buffers), and eagerly, each from the same state
    applied = plan1.apply(step, donate_argnums=0)
    eager = plan1.apply(step, capture=False)
    plain = dataclasses.replace(
        plan1, kernel_sites=[{**r, "impl": "ref"}
                             for r in plan1.kernel_sites]).apply(
                                 step, capture=False)

    def init_state():
        return TS.init_train_state(
            cfg, torch.Generator(device="cuda").manual_seed(seed), opt)

    tgen = torch.Generator(device="cuda").manual_seed(seed + 1)
    batch = train_batch(torch, cfg, B, S, tgen)
    lru = counters["rg_lru"]

    def run(fn, state, label, i):
        """One step through ``fn``; its kernel launches from zero, a
        capture's warm-up and recording taken out and each replay counted
        as the launches its graph recorded."""
        for mod in counters.values():
            mod.launches = 0
        lru.route_launches = dict.fromkeys(lru.ROUTES, 0)
        ops.bwd_calls = ops.rg_lru_bwd_calls = 0
        captures, replays = fn.captures, fn.replays
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        record = MoESelections() if moe and not fn.capture else None
        start.record()
        with record or contextlib.nullcontext():
            state, m = fn(state, batch)
        end.record()
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        if fn.capture:
            (graph,) = fn.graphs
            if fn.captures != captures:
                counts = {k: v - graph.warmup_launches[k] - graph.launches[k]
                          for k, v in counts.items()}
            if any(counts.values()):
                raise AssertionError(f"{label} step {i}: launches outside "
                                     f"the graph {counts}")
            counts = {k: (fn.replays - replays) * graph.launches[k]
                      for k in counts}
        row = {"loss": m["loss"].item(), "grad_norm": m["grad_norm"].item(),
               "ms": start.elapsed_time(end),
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "launches": {k: counts[k] for k in counters},
               "routes": {r: counts[f"rg_lru.{r}"] for r in lru.ROUTES},
               "bwd": {k: counts[f"{k}_bwd"] for k in counters}}
        log(f"[train {name} {label}] step {i}: loss {row['loss']:.6f} "
            f"grad_norm {row['grad_norm']:.6f} {row['ms']:.3f} ms, peak "
            f"{row['peak_gb']:.2f} GB, launches "
            f"{json.dumps(row['launches'])}, rg_lru by route "
            f"{json.dumps(row['routes'])}, backward sites (plain vjp) "
            f"{json.dumps(row['bwd'])}")
        if record is not None:
            row["moe"] = remat_selections(record, cfg, label, i)
        return state, row

    want_launches = {k: sites[k]["launches"] for k in counters}
    want_bwd = {k: sites[k]["forward"] for k in counters}

    def steps(fn, state, label):
        rows = []
        for i in range(1, TRAIN_STEPS + 1):
            state, row = run(fn, state, label, i)
            if row["launches"] != want_launches or \
                    row["bwd"] != want_bwd or \
                    row["routes"] != {"tma": want_launches["rg_lru"],
                                      "generic": 0}:
                raise AssertionError(
                    f"{label} step {i}: launches {row['launches']} (rg_lru "
                    f"by route {row['routes']}), backward sites "
                    f"{row['bwd']}; expected {want_launches}, all on the "
                    f"TMA ring, and {want_bwd}")
            rows.append(row)
        return state, rows

    # step 1 with every site on the plain version first (it also warms
    # the eager path up); its new state is dropped before the kernel
    # steps, so that no more than two train states are ever held.  An
    # MoE model has no site: step 1 forward and backward in f32 instead;
    # another model without a site has no plain path but the eager one,
    # whose step 1 stands for it
    state = init_state()
    prow = None
    if moe:
        prow = f32_step(torch, cfg, state.params, batch, card)
    elif ran:
        prow = run(plain, state, "plain", 1)[1]
        if any(prow["launches"].values()) or prow["bwd"] != want_bwd:
            raise AssertionError("the plain train step launched a kernel")
    # captured: the first call warms up, captures and replays step 1
    mine = pytree.tree_leaves(state)
    state, cap_rows = steps(applied, state, "captured")
    if applied.captures != 1 or applied.replays != TRAIN_STEPS or \
            any(a is not b for a, b in zip(pytree.tree_leaves(state), mine)):
        raise AssertionError(f"captured: {applied.captures} captures, "
                             f"{applied.replays} replays, or the state "
                             f"did not come back in place")
    (graph,) = applied.graphs
    torch.cuda.synchronize()
    cap_mem = {"peak_gb": max(r["peak_gb"] for r in cap_rows[1:]),
               "pool_gb": graph.pool_bytes / 1e9,
               "reserved_gb": torch.cuda.memory_reserved() / 1e9}
    log(f"[capture {name} train B={B} S={S}] 1 graph in "
        f"{graph.seconds:.3f} s, pool {cap_mem['pool_gb']:.3f} GB, "
        f"{len(graph.pairs)} donated leaves written back in the graph, "
        f"launches recorded {json.dumps(graph.launches)}; step 1 (warm-up, "
        f"capture, replay) peak {cap_rows[0]['peak_gb']:.2f} GB")
    # the captured final state goes to the host: two of the hybrid's
    # train states beside its step do not fit on the card
    host = [x.cpu() for x in pytree.tree_leaves(state)]
    applied.release()
    del state, mine, graph
    torch.cuda.empty_cache()
    state, eager_rows = steps(eager, init_state(), "eager")
    eager_mem = {"peak_gb": max(r["peak_gb"] for r in eager_rows[1:]),
                 "reserved_gb": torch.cuda.memory_reserved() / 1e9}
    if prow is None:
        prow = eager_rows[0]
    diffs = state_diffs(torch, host, state)
    same = all(c[k] == e[k] for c, e in zip(cap_rows, eager_rows)
               for k in ("loss", "grad_norm")) and not any(diffs.values())
    if not same:
        # an op with atomics would make two eager runs differ too: the
        # captured run may differ from eager by no more than that
        host_eager = [x.cpu() for x in pytree.tree_leaves(state)]
        del state
        torch.cuda.empty_cache()
        state, again = steps(eager, init_state(), "eager again")
        noise = state_diffs(torch, host_eager, state)
        worse = [p for p, d in diffs.items() if d > noise[p]] + [
            f"step {i + 1} {k}" for i, (c, e, a) in
            enumerate(zip(cap_rows, eager_rows, again))
            for k in ("loss", "grad_norm")
            if abs(c[k] - e[k]) > abs(a[k] - e[k])]
        log(f"[train {name}] captured vs eager differ in "
            f"{sum(d > 0 for d in diffs.values())} leaves, eager vs eager "
            f"in {sum(d > 0 for d in noise.values())}: "
            + json.dumps({p: [diffs[p], noise[p]] for p in diffs
                          if diffs[p] or noise[p]}))
        if worse or moe:
            raise AssertionError(f"captured differs from eager beyond two "
                                 f"eager runs' spread: {worse}"
                                 if worse else "captured differs from "
                                 "eager")
        del host_eager
    del state, host
    torch.cuda.empty_cache()
    log(f"[train {name}] captured (donated) and eager: {TRAIN_STEPS} losses "
        f"and grad norms and the final state ({len(diffs)} leaves) "
        + ("equal bit for bit" if same else "within two eager runs' "
           "spread"))
    ref = "f32" if moe else "plain" if ran else "eager (no site)"
    for key in ("loss", "grad_norm"):
        rel = abs(cap_rows[0][key] - prow[key]) / abs(prow[key])
        log(f"[train {name}] step 1 {key}: "
            f"{'bf16' if moe else 'kernel'} {cap_rows[0][key]:.6f} vs "
            f"{ref} {prow[key]:.6f}, rel {rel:.3e} (tol {TRAIN_REL_TOL})")
        if rel > TRAIN_REL_TOL:
            raise AssertionError(f"train step 1 {key}: "
                                 f"{'bf16' if moe else 'kernel'} and {ref} "
                                 f"disagree")
    losses = [r["loss"] for r in cap_rows]
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        raise AssertionError(f"train losses {losses} not finite or not "
                             f"falling")
    n = T.n_scan_blocks(cfg)
    per = "; ".join(
        f"{k} launches per step {want_launches[k]} = {n} x {v['period']} "
        f"forward + {v['tail']} tail + {n * v['period'] * cfg.remat} "
        f"recomputed (remat), {want_bwd[k]} backward sites on the plain "
        f"vjp" for k, v in sites.items() if v["forward"]) or \
        f"kernel launches per step {json.dumps(want_launches)} (no site)"
    med = {label: percentile([r["ms"] for r in rows[1:]], 0.5)
           for label, rows in (("captured", cap_rows),
                               ("eager", eager_rows))}
    log(f"[train {name}] {card}: {TRAIN_STEPS} steps, loss {losses[0]:.6f} "
        f"-> {losses[-1]:.6f}; {per}; steps 2-{TRAIN_STEPS}: captured median "
        f"{med['captured']:.3f} ms, peak allocated {cap_mem['peak_gb']:.2f} "
        f"GB + pool {cap_mem['pool_gb']:.2f} GB, reserved "
        f"{cap_mem['reserved_gb']:.2f} GB; eager median {med['eager']:.3f} "
        f"ms, peak {eager_mem['peak_gb']:.2f} GB, reserved "
        f"{eager_mem['reserved_gb']:.2f} GB")

    if moe:
        # no kernel site to hold against its plain version
        return {"launches_per_step": want_launches, "steps": cap_rows}
    # small f32 model (remat on, as the full one): loss, every gradient
    # leaf and the updated state, kernel sites vs plain sites
    small = dataclasses.replace(get_config(name).reduced(), use_pallas=True,
                                remat=True)
    if small_layers is not None:
        small = dataclasses.replace(small, num_layers=small_layers)
    sstep = TS.make_train_step(small, opt)
    splan = plan_of(job, "small 1x1")      # traced in the worker process
    splain = dataclasses.replace(
        splan, kernel_sites=[{**r, "impl": "ref"}
                             for r in splan.kernel_sites])
    sstate = TS.init_train_state(
        small, torch.Generator(device="cuda").manual_seed(seed + 2), opt)
    sb = train_batch(torch, small, 2, 64, tgen)
    grads = TS.value_and_grad(TS.make_loss_fn(small), remat=True)
    before = {k: counters[k].launches for k in ran}
    with kernel_dispatch(KernelDispatch(default_impl="cuda")):
        got = grads(sstate.params, sb)
    if any(counters[k].launches == before[k] for k in ran):
        raise AssertionError("the small train step launched no kernel")
    with kernel_dispatch(KernelDispatch(default_impl="ref")):
        want = grads(sstate.params, sb)
    got += splan.apply(sstep, capture=False)(sstate, sb)
    want += splain.apply(sstep, capture=False)(sstate, sb)
    diff = 0.0
    for a, b in zip(pytree.tree_leaves(got), pytree.tree_leaves(want)):
        torch.testing.assert_close(a, b, rtol=SMALL_TOL, atol=SMALL_TOL)
        diff = max(diff, (a.double() - b.double()).abs().max().item())
    log(f"[small train] {small.name} ({small.num_layers} layers) f32 remat: "
        f"loss, {len(pytree.tree_leaves(sstate.params))} gradient leaves "
        f"and the updated state, kernel vs plain: max|diff| {diff:.3e} "
        f"(tol {SMALL_TOL}) ok")
    if small_vs_cpu:
        # the same step on the CPU (the sites' plain versions there); the
        # step with eps 1e-3: with 1e-8 the first AdamW step turns a
        # gradient element near zero into lr * g / |g|, whose sign the
        # two devices need not agree on
        estep = TS.make_train_step(small, dataclasses.replace(opt, eps=1e-3))
        host = pytree.tree_map(lambda x: x.cpu(), (sstate, sb))
        card = got[:3] + splan.apply(estep, capture=False)(sstate, sb)
        cpu = grads(host[0].params, host[1]) + \
            splan.apply(estep, capture=False, device="cpu")(*host)
        diff = 0.0
        for a, b in zip(pytree.tree_leaves(card), pytree.tree_leaves(cpu)):
            torch.testing.assert_close(a.cpu(), b, rtol=SMALL_TOL,
                                       atol=SMALL_TOL)
            diff = max(diff, (a.cpu().double() - b.double()).abs().max()
                       .item())
        log(f"[small train] {small.name} ({small.num_layers} layers) f32 "
            f"remat: loss, gradients and the updated state (eps 1e-3) on "
            f"the card and on the CPU: max|diff| {diff:.3e} (tol "
            f"{SMALL_TOL}) ok")
    return {"launches_per_step": want_launches, "steps": cap_rows}


def drive_launcher(torch, cfg, counters, card, seed: int):
    """Train ``cfg`` through the training launcher (``launch/train.py``):
    once uninterrupted (``--plan manual``, the plan-free ``jit``), and
    once with ``--plan toast``, a failure injected and a restart from the
    latest checkpoint; the second run's final checkpoint must equal the
    first run's final state bit for bit.

    Args:
        cfg: the full-width model configuration (``use_pallas`` set).
        counters: kernel name -> its wrapper module (``launches``).
        card: the card's name and power limit, for the summary line.
        seed: the seed of the weights and the data pipeline.

    Returns:
        The uninterrupted run's :class:`Attempt`, its final state moved
        to the host (the card's memory is the mesh phase's).
    """
    import shutil
    import tempfile

    from repro_torch import pytree
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.launch import train as launcher

    B, S = TRAIN_SHAPE
    name = cfg.name
    common = ["--arch", name, "--batch", str(B), "--seq", str(S),
              "--steps", str(LAUNCH_STEPS), "--seed", str(seed),
              "--log-every", "1"]
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    try:
        for mod in counters.values():
            mod.launches = 0
        t0 = time.perf_counter()
        # the plan-free jit (no trace); its one checkpoint, the last
        # step's, is not read
        (whole,) = launcher.supervise(cfg, launcher.parse_args(
            common + ["--plan", "manual", "--ckpt-dir", str(tmp / "whole"),
                      "--ckpt-every", str(LAUNCH_STEPS)]))
        whole_s = time.perf_counter() - t0
        shutil.rmtree(tmp / "whole")
        free_gb = shutil.disk_usage(tmp).free / 1e9
        t0 = time.perf_counter()
        attempts = launcher.supervise(cfg, launcher.parse_args(
            common + ["--plan", "toast", "--ckpt-dir", str(tmp / "run"),
                      "--ckpt-every", str(LAUNCH_CKPT_EVERY), "--fail-at",
                      str(LAUNCH_FAIL_AT)]))
        run_s = time.perf_counter() - t0
        launches = {k: mod.launches for k, mod in counters.items()}
        runs = attempts + [whole]
        if len(attempts) != 2 or \
                attempts[0].error != "RuntimeError: injected node failure" \
                or attempts[1].start_step != LAUNCH_CKPT_EVERY or \
                [a.replays for a in runs] != [
                    LAUNCH_FAIL_AT, LAUNCH_STEPS - LAUNCH_CKPT_EVERY,
                    LAUNCH_STEPS] or [a.captures for a in runs] != [1] * 3:
            raise AssertionError(
                "launcher: " + "; ".join(
                    f"attempt {a.attempt}: from step {a.start_step}, "
                    f"{a.captures} captures, {a.replays} replays, error "
                    f"{a.error}" for a in runs))
        if not launches["flash_attention"]:
            raise AssertionError("the launcher launched no attention kernel")
        t0 = time.perf_counter()
        step, got = CheckpointManager(tmp / "run").restore(whole.state,
                                                           device="cpu")
        read_s = time.perf_counter() - t0
        diffs = state_diffs(torch, pytree.tree_leaves(got), whole.state)
        if step != LAUNCH_STEPS or any(diffs.values()):
            raise AssertionError(
                f"launcher: final checkpoint step {step}, leaves differing "
                f"from the uninterrupted run: "
                + json.dumps({p: d for p, d in diffs.items() if d}))
        per_step = train_sites(cfg)["flash_attention"]["launches"]
        saves = "; ".join(
            f"step {s['step']} {s['bytes'] / 1e9:.3f} GB: host copy "
            f"{s['snapshot_s']:.3f} s, written {s['write_s']:.3f} s"
            for a in runs for s in a.saves)
        log(f"[launcher {name}] {card}: {cfg.num_layers} layers, B={B} "
            f"S={S}, {LAUNCH_STEPS} steps, "
            f"--plan toast, checkpoint every {LAUNCH_CKPT_EVERY}, failure at "
            f"step {LAUNCH_FAIL_AT}: attempt 0 ran {attempts[0].replays} "
            f"steps and failed; attempt 1 resumed from step "
            f"{attempts[1].start_step} (restore "
            f"{attempts[1].state_bytes / 1e9:.3f} GB to the card in "
            f"{attempts[1].restore_s:.3f} s) and ran "
            f"{attempts[1].replays}; one graph per attempt; {run_s:.1f} s "
            f"(uninterrupted run, --plan manual: {whole_s:.1f} s); saves: "
            f"{saves}; "
            f"disk free {free_gb:.1f} GB")
        replays = sum(a.replays for a in runs)
        log(f"[launcher {name}] flash_attention launches "
            f"{replays * per_step} in {replays} replays x {per_step} "
            f"recorded, {launches['flash_attention']} in the 3 warm-ups and "
            f"captures; "
            f"final checkpoint (step {step}, {len(diffs)} leaves, read to "
            f"the host in {read_s:.3f} s) equals the uninterrupted run's "
            f"final state bit for bit")
        whole.state = pytree.tree_map(lambda x: x.cpu(), whole.state)
        return whole
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def mesh_launcher_rank(rank, name, depth, train_argv, serve_argv):
    """One of the two ranks that share card 0 in the mesh launcher phase.

    Trains ``name`` at full width, cut to ``depth`` layers, through
    ``launch/train.py`` on the (1, 2) mesh (``train_argv``: a failure
    injected and a restart), then serves each model of ``serve_argv``
    through ``launch/serve.py`` on the same two ranks, at its
    ``DECODE_DEPTH``.  Returns what the rank counted: each attempt's
    record (its state dropped), the attention kernel's launches and
    local shapes, the peak memory, and each model's gathered tokens and
    prompt logits."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as server
    from repro_torch.launch import train as launcher

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config(name), use_pallas=True,
                              num_layers=depth)
    fa.launches = 0
    ops.local_calls.clear()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    attempts = launcher.supervise(cfg, launcher.parse_args(train_argv))
    train_s = time.perf_counter() - t0
    out = {"train_s": train_s, "launches": fa.launches,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "local_calls": [[k, impl, shapes, n] for (k, impl, shapes, _), n
                           in ops.local_calls.items()],
           "attempts": [dataclasses.replace(a, state=None)
                        for a in attempts]}
    del attempts
    torch.cuda.empty_cache()
    out["serve"] = {}
    for arch, argv in serve_argv.items():
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = server.serve(server.parse_args(argv), dataclasses.replace(
            get_config(arch), num_layers=DECODE_DEPTH[arch]))
        out["serve"][arch] = {
            "s": time.perf_counter() - t0,
            "tokens": res.tokens.full_tensor().cpu(),
            "prompt_logits": res.prompt_logits.full_tensor().float().cpu(),
            "prefill_ms": res.prefill_ms, "step_ms": res.step_ms,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        del res
        torch.cuda.empty_cache()
    return out


def split_run(torch, cfg, seed: int):
    """The launcher's uninterrupted run on one card, each batch taken as
    two microbatches (``accum_steps=2``): the same math as ``whole``,
    rounded otherwise, as two ranks that split the batch round it.
    Returns its record, the state on the host."""
    from repro_torch import pytree
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.jit import jit
    from repro_torch.launch.train import Attempt
    from repro_torch.train.steps import init_train_state, make_train_step

    B, S = TRAIN_SHAPE
    run = Attempt(0)
    state = init_train_state(
        cfg, torch.Generator(device="cuda").manual_seed(seed), device="cuda")
    step = jit(make_train_step(cfg, accum_steps=2), "cuda", capture=False,
               donate_argnums=0)
    pipe = Pipeline(cfg, ShapeConfig("cli", S, B, "train"),
                    DataConfig(seed=seed))
    try:
        for _ in range(LAUNCH_STEPS):
            _, batch = next(pipe)
            state, metrics = step(state, {k: torch.from_numpy(v).cuda()
                                          for k, v in batch.items()})
            run.losses.append((metrics["loss"].item(),
                               metrics["grad_norm"].item()))
    finally:
        pipe.close()
    run.state = pytree.tree_map(lambda x: x.cpu(), state)
    return run


def drive_mesh_launcher(torch, cfg, hybrid, whole, card, seed: int):
    """The mesh launcher phase: ``cfg`` trained through ``launch/train.py``
    on two ranks of one gloo group sharing card 0, ``--plan toast`` on
    the (1, 2) mesh, a failure at step ``LAUNCH_FAIL_AT`` and a restart;
    then one request served through ``launch/serve.py`` on the same ranks
    for ``cfg`` and ``hybrid``, each at its ``DECODE_DEPTH``.  The final
    checkpoint is held against the one-card uninterrupted run ``whole``
    (its state on the host): the
    step, each step's loss and grad norm within 2e-2, and each leaf
    within 2e-2 beyond the distance from ``whole`` of one card's run of
    the same batches in two microbatches (:func:`split_run`); the served
    prompt logits against one card's serve of the same prompts.

    Returns:
        Per rank, the attention kernel's launches per step.
    """
    import shutil
    import tempfile

    from repro_torch import pytree
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as server
    from repro_torch.launch.mesh import run_ranks

    B, S = TRAIN_SHAPE
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_ckpt_"))
    try:
        train_argv = [
            "--arch", cfg.name, "--batch", str(B), "--seq", str(S),
            "--steps", str(LAUNCH_STEPS), "--seed", str(seed),
            "--log-every", "1", "--plan", "toast", "--ckpt-dir", str(tmp),
            "--ckpt-every", str(LAUNCH_CKPT_EVERY), "--fail-at",
            str(LAUNCH_FAIL_AT)]
        serve_argv = {m.name: ["--arch", m.name, "--batch",
                               str(MESH_SERVE[0]), "--prompt-len",
                               str(MESH_SERVE[1]), "--gen",
                               str(MESH_SERVE[2]), "--seed", str(seed)]
                      for m in (cfg, hybrid)}
        split = split_run(torch, cfg, seed)
        # the one-card serve of the same prompts (the same seeded weights)
        one = {}
        for arch, argv in serve_argv.items():
            res = server.serve(
                server.parse_args(argv + ["--plan", "manual"]),
                dataclasses.replace(get_config(arch),
                                    num_layers=DECODE_DEPTH[arch]))
            one[arch] = (res.tokens.cpu(), res.prompt_logits.float().cpu())
            del res
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        log(f"[mesh launcher] before the ranks the parent holds "
            f"{torch.cuda.memory_reserved() / 1e9:.3f} GB reserved, "
            f"{torch.cuda.memory_allocated() / 1e9:.3f} GB allocated")
        t0 = time.perf_counter()
        ranks = run_ranks(mesh_launcher_rank, 2, cfg.name, cfg.num_layers,
                          train_argv,
                          {k: v + ["--plan", "toast"]
                           for k, v in serve_argv.items()},
                          timeout=MESH_LAUNCH_TIMEOUT)
        wall = time.perf_counter() - t0
        per_step = train_sites(cfg)["flash_attention"]["launches"]
        ran = LAUNCH_FAIL_AT + LAUNCH_STEPS - LAUNCH_CKPT_EVERY
        for rank, res in enumerate(ranks):
            a0, a1 = res["attempts"]
            if a0.error != "RuntimeError: injected node failure" or \
                    a1.start_step != LAUNCH_CKPT_EVERY or a1.error or \
                    len(a0.step_ms) + len(a1.step_ms) != ran:
                raise AssertionError(
                    f"mesh launcher rank {rank}: attempts "
                    + "; ".join(f"from step {a.start_step}, "
                                f"{len(a.step_ms)} steps, error {a.error}"
                                for a in res["attempts"]))
            log(f"[mesh launcher rank {rank}] rules {a1.rules} on "
                f"{a1.mesh}; state {a1.state_bytes / 1e9:.3f} GB on this "
                f"rank; peak {res['peak_gb']:.2f} GB (training and saving)")
            for a in res["attempts"]:
                steps = len(a.step_ms)
                calls = {k: v / steps for k, v in
                         a.collectives["calls"].items()}
                nbytes = {k: v / steps for k, v in
                          a.collectives["bytes"].items()}
                log(f"[mesh launcher rank {rank}] {card}: attempt "
                    f"{a.attempt} from step {a.start_step}: step ms "
                    f"{fmt_ms(a.step_ms)} (host clock, card synchronized; "
                    f"two ranks time-sharing one H100 over gloo: not a "
                    f"multi-card figure); collectives per step "
                    + json.dumps(calls) + ", result bytes per step "
                    + json.dumps(nbytes) + ", host s in them and their "
                    "waits " + json.dumps({k: round(v, 3) for k, v in
                                           a.collectives["seconds"].items()}))
                for sv in a.saves:
                    log(f"[mesh launcher rank {rank}] save step "
                        f"{sv['step']}: {sv['bytes'] / 1e9:.3f} GB whole, "
                        f"{sv['local_bytes'] / 1e9:.3f} GB of shards off "
                        f"the card, made whole on the host in "
                        f"{sv['snapshot_s']:.3f} s, written "
                        + ("-" if sv["write_s"] is None else
                           f"{sv['write_s']:.3f} s"))
            log(f"[mesh launcher rank {rank}] restart resumed from step "
                f"{a1.start_step}, restore onto the shards "
                f"{a1.restore_s:.3f} s; flash_attention launches "
                f"{res['launches']} in {ran} steps; local sites "
                + json.dumps(res["local_calls"]))
            if res["launches"] != per_step * ran:
                raise AssertionError(
                    f"mesh launcher rank {rank}: {res['launches']} "
                    f"attention launches, expected {per_step} x {ran}")
        # the final checkpoint against one card's whole-batch run, each
        # leaf within 2e-2 beyond the distance from that run of one card's
        # run of the same batches in two microbatches (the same math
        # rounded otherwise, as the ranks' batch halves are): in bf16,
        # after 6 AdamW steps, a leaf whose gradient cancels (the key
        # bias) moves by more than 2e-2 under any such regrouping
        t0 = time.perf_counter()
        step, got = CheckpointManager(tmp).restore(whole.state,
                                                   device="cpu")
        read_s = time.perf_counter() - t0
        worst, above = (0.0, "", 0.0), []
        for a, b, c, path in zip(pytree.tree_leaves(got),
                                 pytree.tree_leaves(whole.state),
                                 pytree.tree_leaves(split.state),
                                 pytree.flatten_with_paths(whole.state)[1]):
            a, b, c = a.double(), b.double(), c.double()
            rel = ((a - b).norm() / b.norm().clamp_min(1e-30)).item()
            floor = ((c - b).norm() / b.norm().clamp_min(1e-30)).item()
            worst = max(worst, (rel, path, floor))
            if rel > TRAIN_REL_TOL:
                above.append(f"{path} {rel:.3e} (floor {floor:.3e})")
            if rel > floor + TRAIN_REL_TOL:
                raise AssertionError(
                    f"mesh launcher: final leaf {path} differs by "
                    f"{rel:.3e} from one card's run, whose two-microbatch "
                    f"run differs by {floor:.3e}")
        mesh_losses = dict(
            (a.start_step + i + 1, lg) for a in ranks[0]["attempts"]
            for i, lg in enumerate(a.losses))
        loss_rel = 0.0
        for i, (loss, gnorm) in enumerate(whole.losses):
            m_loss, m_gnorm = mesh_losses[i + 1]
            loss_rel = max(loss_rel, abs(m_loss - loss) / abs(loss),
                           abs(m_gnorm - gnorm) / abs(gnorm))
        if step != LAUNCH_STEPS or loss_rel > TRAIN_REL_TOL:
            raise AssertionError(f"mesh launcher: final step {step}, "
                                 f"losses and grad norms {loss_rel:.3e} "
                                 f"relative from one card's")
        log(f"[mesh launcher {cfg.name}] final checkpoint step {step} "
            f"(read in {read_s:.3f} s) vs the one-card uninterrupted run: "
            f"worst leaf |a-b|/|b| {worst[0]:.3e} ({worst[1]}; one card's "
            f"two-microbatch run {worst[2]:.3e} from it); above "
            f"{TRAIN_REL_TOL}: {above or 'none'}; losses and grad norms "
            f"{loss_rel:.3e} relative (tol {TRAIN_REL_TOL})")
        for arch, (tokens, logits) in one.items():
            for rank, res in enumerate(ranks):
                got = res["serve"][arch]
                rel = ((got["prompt_logits"] - logits).abs().max() /
                       logits.abs().max()).item()
                same = torch.equal(got["prompt_logits"].argmax(-1),
                                   logits.argmax(-1))
                agree = (got["tokens"] == tokens).float().mean().item()
                log(f"[mesh serve {arch} rank {rank}] {card}: 1x2 on two "
                    f"ranks vs one card: prompt logits max|diff|/max "
                    f"{rel:.3e} (tol {LOGITS_REL_TOL}), argmax "
                    f"{'equal' if same else 'differs'}, tokens equal "
                    f"{agree:.0%}; prefill {got['prefill_ms']:.1f} ms, "
                    f"decode median {percentile(got['step_ms'], 0.5):.2f} "
                    f"ms per token (CUDA events on the rank), peak "
                    f"{got['peak_gb']:.2f} GB, {got['s']:.1f} s with the "
                    f"search")
                if rel > LOGITS_REL_TOL or not same:
                    raise AssertionError(f"{arch}: mesh and one-card "
                                         f"serve disagree")
        log(f"[mesh launcher] two ranks: {wall:.1f} s wall, the ranks' "
            f"start included")
        return [r["launches"] // ran for r in ranks]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def graph_nodes(torch, fn, *args) -> tuple[int, float]:
    """Capture ``fn(*args)`` once more as a CUDA graph kept for
    inspection: the graph's nodes (each a kernel launch, copy or fill the
    capture recorded, read with libcuda's ``cuGraphGetNodes``) and the
    device ms of one replay."""
    import ctypes
    fn(*args)                               # warm-up, on the same stream
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn(*args)
    get_nodes = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes
    get_nodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.POINTER(ctypes.c_size_t)]
    get_nodes.restype = ctypes.c_int
    count = ctypes.c_size_t(0)
    rc = get_nodes(graph.raw_cuda_graph(), None, ctypes.byref(count))
    if rc != 0:
        raise RuntimeError(f"cuGraphGetNodes returned {rc}")
    graph.instantiate()
    ms = cuda_ms(graph.replay, 3, warmup=1)
    del graph
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return count.value, ms


def drive_xlstm(torch, counters, card, jobs) -> dict:
    """Plan and serve ``xlstm_350m`` at full width and full depth:
    prefill and decode through the 1x1 plans of its steps, no kernel
    site; the sLSTM time loop's launches and time share; a small f32
    model on the card against the same model on the CPU.

    Args:
        counters: kernel name -> its wrapper module (``launches``).
        card: the card's name and power limit, for the time lines.
        jobs: the :func:`plan_job` results of its prefill and decode
            steps, by kind.

    Returns:
        The kernels' launches on the prefill path, captured and eager
        (none, or it fails).
    """
    from repro_torch import pytree
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.train.steps import make_prefill_step

    t_start = time.perf_counter()
    cfg = dataclasses.replace(get_config(XLSTM), use_pallas=True)
    B, S = XLSTM_SHAPE
    job = jobs["prefill"]
    st = job["stats"]
    plan8 = plan_of(job, "2x4")
    specs = {p: tuple(s) for p, s in zip(plan8.input_paths, plan8.in_specs)
             if p.endswith(("['mix']['R']", "['mix']['W']"))}
    log(f"[xlstm plan {cfg.name} prefill 2x4] {cfg.num_layers} layers, "
        f"B={B} S={S}: {job['seconds']:.3f} s to the plans in the worker "
        f"process (trace {st['phases']['trace']:.3f} s, search "
        f"{plan8.search_seconds:.3f} s), {st['ops']} ops, trip counts "
        f"{st['trips']}, {st['colors']} colors, {st['conflicts']} "
        f"conflicts, cost {plan8.cost:.6f}, sLSTM weights "
        f"{json.dumps(specs)}, rules {json.dumps(plan8.logical_rules)}, "
        f"json round-trip ok")
    plan1 = plan_of(job, "1x1")
    if plan1.kernel_sites or any(sum(n) for n in
                                 T.kernel_sites(cfg).values()):
        raise AssertionError(f"{cfg.name} has kernel sites "
                             f"{plan1.kernel_sites}")
    log(f"[partition {cfg.name} 1x1] cost={plan1.cost:.6f} no kernel sites")
    step = make_prefill_step(cfg)
    applied = plan1.apply(step)
    eager = plan1.apply(step, capture=False)
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(x.numel() for x in pytree.tree_leaves(params))
    log(f"[xlstm {cfg.name}] {n_params / 1e6:.1f} M parameters, "
        f"{tree_bytes(params) / 1e9:.3f} GB of bf16 weights")
    tgen = torch.Generator(device="cuda").manual_seed(1)
    requests = [{"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                         generator=tgen, device="cuda",
                                         dtype=torch.int32)}
                for _ in range(REQUESTS)]
    t0 = time.perf_counter()
    eager(params, requests[0])              # warm-up, not counted
    torch.cuda.synchronize()
    log(f"[xlstm {cfg.name}] eager warm-up request "
        f"{time.perf_counter() - t0:.3f} s on the host")
    graph = capture_once(torch, applied, f"{cfg.name} prefill B={B} S={S}",
                         params, requests[0])
    if any(graph.launches.values()) or any(graph.warmup_launches.values()):
        raise AssertionError(f"{cfg.name}: the graph recorded kernel "
                             f"launches {graph.launches}")
    for mod in counters.values():
        mod.launches = 0
    replays = applied.replays
    outs = {"captured": [], "eager": []}
    times = {"captured": [], "eager": []}
    for i, req in enumerate(requests):
        order = ("captured", "eager") if i % 2 == 0 else ("eager", "captured")
        for label in order:
            fn = applied if label == "captured" else eager
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            logits = fn(params, req)
            end.record()
            torch.cuda.synchronize()
            if logits.shape != (B, cfg.vocab_size) or \
                    not torch.isfinite(logits).all():
                raise AssertionError(f"{cfg.name} {label} request {i}: "
                                     f"logits not finite or misshapen")
            times[label].append(start.elapsed_time(end))
            outs[label].append(logits.float())
            log(f"[serve {cfg.name} {label}] request {i}: next tokens "
                f"{logits.float().argmax(-1).tolist()} prefill "
                f"{times[label][-1]:.3f} ms, peak "
                f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, reserved "
                f"{torch.cuda.memory_reserved() / 1e9:.2f} GB")
    launches = graph_launches(counters, applied, replays)
    launches = {k: launches[k] for k in counters}
    if any(launches.values()):
        raise AssertionError(f"{cfg.name}: kernel launches {launches}")
    if applied.captures != 1 or applied.replays - replays != REQUESTS:
        raise AssertionError(f"{cfg.name}: {applied.captures} captures, "
                             f"{applied.replays - replays} replays")
    for i, (a, b) in enumerate(zip(outs["captured"], outs["eager"])):
        if not torch.equal(a, b):
            raise AssertionError(f"{cfg.name} request {i}: captured and "
                                 f"eager logits differ, max|diff| "
                                 f"{(a - b).abs().max().item():.3e}")
        log(f"[serve {cfg.name}] request {i}: captured logits equal eager "
            f"bit for bit")
    cap_med = percentile(times["captured"], 0.5)
    log(f"[xlstm {cfg.name}] kernel launches on the prefill path: "
        f"{json.dumps(launches)} ({REQUESTS} replays, {REQUESTS} eager)")
    log(f"[prefill time] {card}: {cfg.name} B={B} S={S} per request, "
        f"captured {fmt_ms(times['captured'])} (median {cap_med:.3f}), "
        f"eager {fmt_ms(times['eager'])} (median "
        f"{percentile(times['eager'], 0.5):.3f}); capture "
        f"{graph.seconds:.3f} s, graph pool {graph.pool_bytes / 1e9:.3f} GB")
    del graph, outs
    applied.release()
    del applied, eager
    torch.cuda.empty_cache()

    # the sLSTM time loop: one block of each kind at the prefill's shape,
    # captured alone; its graph's nodes are its launches
    x = torch.randn((B, S, cfg.d_model), generator=tgen, device="cuda",
                    dtype=cfg.dtype)
    kinds, _ = T.block_kinds(cfg)
    per_kind = {}
    for kind, fn in (("slstm", L.slstm_apply), ("mlstm", L.mlstm_apply)):
        j = kinds.index(kind)
        p = {k: v[0] for k, v in params["layers"][j]["mix"].items()}
        nodes, ms = graph_nodes(torch, lambda p, x: fn(cfg, p, x), p, x)
        n = cfg.num_layers // len(kinds) * kinds.count(kind)
        per_kind[kind] = {"nodes": nodes, "ms": ms, "layers": n}
        log(f"[xlstm {kind}] one block at B={B} S={S} captured alone: "
            f"{nodes} graph nodes ({nodes / S:.1f} a step), replay "
            f"{ms:.3f} ms; x {n} layers = {n * nodes} launches, "
            f"{n * ms:.3f} ms = {n * ms / cap_med:.1%} of the captured "
            f"request's median")
    del x

    drive_decode(torch, *cut_depth(cfg, params, DECODE_DEPTH[XLSTM]),
                 counters, card, jobs["decode"],
                 dataclasses.replace(get_config(XLSTM).reduced(),
                                     num_layers=XLSTM_SMALL_LAYERS))
    del params
    torch.cuda.empty_cache()

    # the small f32 model on the card against the same one on the CPU
    small = dataclasses.replace(get_config(XLSTM).reduced(),
                                num_layers=XLSTM_SMALL_LAYERS)
    host = T.init_params(small, torch.Generator().manual_seed(5), "cpu")
    toks = torch.randint(0, small.vocab_size, (2, 64),
                         generator=torch.Generator().manual_seed(6),
                         dtype=torch.int32)
    want = T.forward(small, host, toks)
    got = T.forward(small, pytree.tree_map(lambda t: t.cuda(), host),
                    toks.cuda()).cpu()
    torch.testing.assert_close(got, want, rtol=SMALL_TOL, atol=SMALL_TOL)
    log(f"[small] {small.name} ({small.num_layers} layers, 2 sLSTM) f32 "
        f"forward on the card vs the CPU: max|diff| "
        f"{(got - want).abs().max().item():.3e} (tol {SMALL_TOL}) ok")
    log(f"[elapsed] xLSTM phase {time.perf_counter() - t_start:.1f} s")
    return {"launches": launches, "blocks": per_kind}


def prefill_requests(torch, cfg, gen, shape, n: int) -> list:
    """``n`` seeded prefill batches at ``shape`` (B, S positions): a
    decoder's tokens, whisper's frames (S/2) and tokens (S/2),
    phi3_vision's patch embeddings (its patches) and tokens (the rest),
    the frames and patches f32 as the specs give them."""
    B, S = shape
    out = []
    for _ in range(n):
        batch, n_tokens = {}, S
        if cfg.is_encoder_decoder:
            batch["frames"] = torch.randn((B, S // 2, cfg.d_model),
                                          generator=gen, device="cuda")
            n_tokens = S // 2
        elif cfg.frontend:
            batch["patch_embeds"] = torch.randn(
                (B, cfg.num_patches, cfg.d_model), generator=gen,
                device="cuda")
            n_tokens = S - cfg.num_patches
        batch["tokens"] = torch.randint(0, cfg.vocab_size, (B, n_tokens),
                                        generator=gen, device="cuda",
                                        dtype=torch.int32)
        out.append(batch)
    return out


def drive_frontend(torch, name, counters, card, jobs, shape) -> dict:
    """Plan and serve a frontend model at full width and full depth:
    ``whisper_small`` (its encoder's sites non-causal, its decoder's
    causal) or ``phi3_vision`` (its sites at head dim 96): its prefill
    path (:func:`drive_path`), each site held at its own q, k, v against
    the plain version, whisper's encoder output against the plain
    sites; then its decode path; for whisper the serving launcher's
    command line once.

    Args:
        name: ``WHISPER`` or ``PHI3V``.
        counters: kernel name -> its wrapper module (``launches``).
        card: the card's name and power limit, for the time lines.
        jobs: the :func:`plan_job` results of its prefill and decode
            steps, by kind.
        shape: (B, S positions) of each prefill request.

    Returns:
        The attention kernel's launches per request, as counted, and each
        site's largest error against the plain version, by causality.
    """
    from repro_torch import pytree
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.models.sharding import KernelDispatch, kernel_dispatch
    from repro_torch.train.steps import make_prefill_step

    fa = counters["flash_attention"]
    t_start = time.perf_counter()
    cfg = dataclasses.replace(get_config(name), use_pallas=True)
    B, S = shape
    job = jobs["prefill"]
    st = job["stats"]
    plan8 = plan_of(job, "2x4")
    enc = f" + {cfg.encoder_layers} encoder layers" \
        if cfg.encoder_layers else ""
    log(f"[frontend plan {name} prefill 2x4] {cfg.num_layers} layers{enc}"
        f", B={B} S={S}: {job['seconds']:.3f} s to the plans in the worker "
        f"process (trace {st['phases']['trace']:.3f} s, search "
        f"{plan8.search_seconds:.3f} s), {st['ops']} ops, trip counts "
        f"{st['trips']}, {st['colors']} colors, {st['conflicts']} "
        f"conflicts, cost {plan8.cost:.6f}, kernel ops {st['kernel_ops']}, "
        f"sites " + json.dumps({r["site"]: [r["impl"], r["sharded"]]
                                for r in plan8.kernel_sites})
        + f", rules {json.dumps(plan8.logical_rules)}")
    per_request = cfg.num_layers + cfg.encoder_layers
    n_sites = 2 if cfg.is_encoder_decoder else 1
    launched, _, params, logits = drive_path(
        torch, cfg, job, shape, counters, "flash_attention", per_request,
        card, [f"flash_attention:{i}" for i in range(n_sites)])
    n_params = sum(x.numel() for x in pytree.tree_leaves(params))
    log(f"[frontend {name}] {n_params / 1e9:.3f} B parameters, "
        f"{tree_bytes(params) / 1e9:.3f} GB of bf16 weights")

    # every site at the model's own q, k, v (the first request, eager,
    # recorded): the kernel against the plain version
    site_errs = {False: [], True: []}
    real_attention = ops.attention

    def recorded(q, k, v, *, causal=True):
        got = fa.flash_attention(q, k, v, causal=causal)
        want = fa.reference(q, k, v, causal=causal)
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=FA_TOL["bfloat16"],
                                   atol=FA_TOL["bfloat16"])
        site_errs[causal].append(
            ((got.float() - want.float()).abs().max().item(),
             tuple(q.shape)))
        return real_attention(q, k, v, causal=causal)

    (request,) = prefill_requests(
        torch, cfg, torch.Generator(device="cuda").manual_seed(1), shape, 1)
    eager = plan_of(job, "1x1").apply(make_prefill_step(cfg), capture=False)
    ops.attention = recorded
    try:
        got = eager(params, request).float()
    finally:
        ops.attention = real_attention
    if not torch.equal(got, logits[0]):
        raise AssertionError(f"{name}: a recorded eager run differs from "
                             f"the captured run")
    want_sites = {False: cfg.encoder_layers, True: cfg.num_layers}
    for causal, errs in site_errs.items():
        if len(errs) != want_sites[causal]:
            raise AssertionError(f"{name}: {len(errs)} sites with causal="
                                 f"{causal}, expected {want_sites[causal]}")
        if errs:
            worst = max(e for e, _ in errs)
            log(f"[kernel] flash_attention at {name}'s {len(errs)} "
                f"{'causal decoder' if causal else 'non-causal encoder'} "
                f"sites, their own q {errs[0][1]} bf16: max|err|="
                f"{worst:.3e} (within rtol = atol = {FA_TOL['bfloat16']}) "
                f"ok")
    if cfg.is_encoder_decoder:
        # the encoder's output through the kernel and the plain sites
        frames = request["frames"]
        before = {k: mod.launches for k, mod in counters.items()}
        with kernel_dispatch(KernelDispatch(default_impl="ref")):
            b = T.encode(cfg, params, frames).float()
        if {k: mod.launches for k, mod in counters.items()} != before:
            raise AssertionError("the plain path launched a kernel")
        with kernel_dispatch(KernelDispatch(default_impl="cuda")):
            a = T.encode(cfg, params, frames).float()
        rel = ((a - b).abs().max() / b.abs().max()).item()
        log(f"[frontend {name}] encode {tuple(frames.shape)}: "
            f"max|kernel-plain|/max|plain| = {rel:.3e} (tol "
            f"{LOGITS_REL_TOL}), finite {bool(torch.isfinite(a).all())}")
        if rel > LOGITS_REL_TOL or not torch.isfinite(a).all():
            raise AssertionError("kernel and plain encoder outputs disagree")
        del a, b
    del eager, logits, request
    torch.cuda.empty_cache()

    drive_decode(torch, *cut_depth(cfg, params, DECODE_DEPTH[name]),
                 counters, card, jobs["decode"])
    del params
    torch.cuda.empty_cache()
    if cfg.is_encoder_decoder:
        # the serving launcher, as a user runs it on the card
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
             name], cwd=REPO, capture_output=True, text=True, timeout=300,
            env={**os.environ, "PYTHONPATH": str(REPO / "src")})
        if run.returncode != 0:
            raise AssertionError(f"serve CLI --arch {name} failed:\n"
                                 f"{run.stdout}{run.stderr}")
        lines = run.stdout.strip().splitlines()
        if len(lines) != 5 or not lines[0].startswith("prefill:"):
            raise AssertionError(f"serve CLI --arch {name}: {run.stdout}")
        for line in lines:
            log(f"[serve cli {name}] {line}")
        log(f"[serve cli {name}] {time.perf_counter() - t0:.1f} s with the "
            f"process start")
    log(f"[elapsed] {name} frontend phase "
        f"{time.perf_counter() - t_start:.1f} s")
    return {"launches": launched // REQUESTS,
            "site_errs": {"causal" if c else "non-causal": max(
                (e for e, _ in errs), default=None)
                for c, errs in site_errs.items()}}


def drive_frontend_train(torch, name, counters, card, seed: int, job,
                         full_job=None) -> dict:
    """Train ``name`` at full width, cut to its ``FRONTEND_TRAIN`` depth,
    through :func:`drive_train` (the small f32 model held against the
    CPU too); report the 2x4 plan of its full-depth train step when the
    card runs a cut one.

    Args:
        job: the :func:`plan_job` result of the train step run (its 1x1
            plan runs it).
        full_job: the same for the full-depth train step (its 2x4 plan
            is reported), or ``None``.

    Returns:
        :func:`drive_train`'s result, with the phase's seconds.
    """
    from repro_torch.configs import get_config
    t_start = time.perf_counter()
    depth, (B, S), small_layers, remat = FRONTEND_TRAIN[name]
    full = dataclasses.replace(get_config(name), use_pallas=True)
    if full_job is not None:
        plan = plan_of(full_job, "2x4")
        st = full_job["stats"]
        log(f"[train plan {name} 2x4] full depth, {full.num_layers} "
            f"layers, B={B} S={S}: {full_job['seconds']:.3f} s to the plans "
            f"in the worker process (trace {st['phases']['trace']:.3f} s, "
            f"search {plan.search_seconds:.3f} s), {st['ops']} ops, trip "
            f"counts {st['trips']}, {st['colors']} colors, "
            f"{st['conflicts']} conflicts, cost {plan.cost:.6f}, predicted "
            f"peak {plan.breakdown['peak_bytes'] / 1e9:.3f} GB a chip, "
            f"rules {json.dumps(plan.logical_rules)}, json round-trip ok")
        if st["trips"] != train_trips(full, S):
            raise AssertionError(f"{name} full-depth train trip counts "
                                 f"{st['trips']}")
    cfg = full if depth is None else dataclasses.replace(full,
                                                         num_layers=depth)
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat=remat)
    out = drive_train(torch, cfg, counters, card, seed, (B, S), TRAIN_OPT,
                      job, small_layers, small_vs_cpu=True)
    out["seconds"] = time.perf_counter() - t_start
    log(f"[elapsed] {name} train phase {out['seconds']:.1f} s")
    return out


def family_cfg(name: str, depth: int):
    """``name`` at full width with its kernel sites, cut to ``depth``
    layers (an encoder-decoder's encoder too)."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(name), use_pallas=True,
                              num_layers=depth)
    if cfg.encoder_layers:
        cfg = dataclasses.replace(cfg, encoder_layers=depth)
    if name == XLSTM:
        # as in 7h: remat would run the sLSTM's host-bound time loop again
        # in each backward.  In f32: in bf16 the mLSTM's gate weights'
        # gradients cancel to rounding noise (their moments 0.1-0.7 apart,
        # relative, between two regroupings of the same three steps on one
        # H100), which no leaf check can hold to a floor
        cfg = dataclasses.replace(cfg, remat=False, param_dtype="float32")
    return cfg


def family_mesh_job(name: str, hbm: float) -> dict:
    """Host work of phase 7i for one model, in the worker process (no card
    is touched): trace the cut model's prefill step (``FAMILY_MESH``'s
    request shape), its train step (its train shape, AdamW of
    ``FAMILY_MESH_OPT``) and its decode step (the serving launcher's, at
    ``MESH_SERVE``) on ``meta`` tensors, and search the prefill and train
    steps' (1, 2) plans with a ``HardwareSpec`` whose ``hbm_per_chip`` is
    ``hbm`` (each rank's share of the card), the prefill's 1x1 plan and
    the launcher's decode plan for two devices.  Returns each session's
    figures and each plan's JSON."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    from repro_torch.api import Request, Session
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.cost_model import HardwareSpec, MeshSpec
    from repro_torch.core.partitioner import ShardingPlan
    from repro_torch.launch import serve
    from repro_torch.launch.specs import batch_specs
    from repro_torch.models import transformer as T
    from repro_torch.optim.adam import AdamConfig
    from repro_torch.train import steps as TS

    depth, (B, S), (Bt, St) = FAMILY_MESH[name]
    cfg = family_cfg(name, depth)
    opt = AdamConfig(**FAMILY_MESH_OPT)
    mesh2 = MeshSpec(("data", "model"), MESH_SHAPE)
    hw = dataclasses.replace(HardwareSpec(), hbm_per_chip=hbm)
    Bd, P, G = MESH_SERVE
    t0 = time.perf_counter()
    prefill = Session(TS.make_prefill_step(cfg), (
        T.param_specs(cfg),
        batch_specs(cfg, ShapeConfig("p", S, B, "prefill"))[0]))
    train = Session(TS.make_train_step(cfg, opt), (
        TS.train_state_specs(cfg, opt),
        batch_specs(cfg, ShapeConfig("t", St, Bt, "train"))[0]))
    decode, names = serve.decode_session(cfg, Bd, P + G)
    plans = {
        "1x2": prefill.partition(Request(mesh=mesh2, hw=hw)),
        "1x1": prefill.partition(Request(mesh=MeshSpec(("data", "model"),
                                                       (1, 1)))),
        "train 1x2": train.partition(Request(mesh=mesh2, hw=hw)),
        "decode 1x2": decode.partition(serve.decode_request(cfg, names,
                                                            mesh2))}
    out = {"plans": {}, "stats": {}, "hbm": hbm}
    for label, plan in plans.items():
        if ShardingPlan.from_json(plan.to_json()).as_dict() != \
                plan.as_dict():
            raise AssertionError(f"{name} {label} plan JSON does not "
                                 f"round-trip")
        out["plans"][label] = plan.to_json()
    for label, sess in (("prefill", prefill), ("train", train),
                        ("decode", decode)):
        prog = sess.artifacts.prog
        out["stats"][label] = {
            "ops": len(prog.ops),
            "conflicts": len(sess.artifacts.analysis.conflicts),
            "trips": sorted(set(prog.trip_counts.values()))}
    out["seconds"] = time.perf_counter() - t0
    return out


class ScanProbe:
    """While open, each per-shard scan (``sharding.scan_per_shard``: the
    sLSTM's time loop) on this rank is timed on the host clock with the
    card synchronized, and the DTensor ops and collectives it issues are
    counted (``launch.mesh.dtensor_ops``, ``collective_tally``; the plain
    ops of its local loop, which no dispatch mode sees here, are not).
    ``calls``: (seconds, DTensor ops, collectives) per scan."""

    def __enter__(self):
        import torch
        from torch.utils._python_dispatch import _disable_current_modes

        from repro_torch.launch import mesh as M
        from repro_torch.models import sharding
        self.calls, self._saved = [], sharding.scan_per_shard
        saved = self._saved

        def probe(fn, operands, *args, **kwargs):
            def local(*xs):
                with _disable_current_modes():
                    return fn(*xs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with M.dtensor_ops() as ops, M.collective_tally() as tally:
                out = saved(local, operands, *args, **kwargs)
            torch.cuda.synchronize()
            self.calls.append((time.perf_counter() - t0,
                               sum(ops.calls.values()),
                               sum(tally.calls.values())))
            return out
        sharding.scan_per_shard = probe
        return self

    def __exit__(self, *exc):
        from repro_torch.models import sharding
        sharding.scan_per_shard = self._saved


def family_mesh_rank(rank, jobs, seed: int, out_dir: str) -> dict:
    """One of the two ranks that share card 0 in phase 7i.  For each cut
    model (``jobs``: name -> its :func:`family_mesh_job` plans): the
    prefill request through ``plan.apply`` of the (1, 2) plan, the
    seeded weights placed leaf by leaf; one ``MESH_SERVE`` request
    through the serving launcher's route (``serve.serve_replicated``:
    the weights, the cache, the prompts and whisper's encoder output,
    encoded on each rank before placement, replicated; the decode plan's
    rules); then ``FAMILY_MESH_STEPS`` steps through ``plan.apply(step,
    donate_argnums=0)`` of the (1, 2) train plan from the seeded state
    on the fixed seeded batch, the final state's blocks saved under
    ``out_dir/<name>``.  Each timed on the host clock with the card
    synchronized, under the collective tally and :class:`ScanProbe`.
    Returns, per model, the gathered logits, tokens and metrics and what
    the rank counted."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor

    from repro_torch import pytree
    from repro_torch.core.partitioner import ShardingPlan
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import rg_lru as lru
    from repro_torch.launch import mesh as M
    from repro_torch.launch import serve
    from repro_torch.models import sharding
    from repro_torch.models import transformer as T
    from repro_torch.optim import adam
    from repro_torch.optim.adam import AdamConfig
    from repro_torch.train import steps as TS

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def local_sites():
        return [[k, impl, shp, n] for (k, impl, shp, _), n in
                ops.local_calls.items()]

    def seeded(offset):
        return torch.Generator(device="cuda").manual_seed(seed + offset)

    out = {}
    for name, plans in jobs.items():
        depth, shape, (Bt, St) = FAMILY_MESH[name]
        cfg = family_cfg(name, depth)
        res = {}
        # the prefill request through the (1, 2) plan
        applied = ShardingPlan.from_json(plans["1x2"]).apply(
            TS.make_prefill_step(cfg))
        torch.cuda.reset_peak_memory_stats()
        params = T.init_params(cfg, seeded(0))
        place_in_place(applied, params)
        (request,) = prefill_requests(torch, cfg, seeded(1), shape, 1)
        fa.launches = lru.launches = 0
        ops.local_calls.clear()
        sharding.made_whole.clear()
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with M.collective_tally() as tally, ScanProbe() as probe:
            y = applied(params, request)
            torch.cuda.synchronize()
        res["prefill"] = {
            "ms": (time.perf_counter() - t0) * 1e3,
            "logits": y.full_tensor().float().cpu(),
            "launches": fa.launches, "rg_lru": lru.launches,
            "local_calls": local_sites(),
            "calls": dict(tally.calls), "bytes": dict(tally.bytes),
            "scans": probe.calls, "made_whole": dict(sharding.made_whole),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        del applied, params, request, y
        torch.cuda.empty_cache()

        # one request served through the launcher's route
        dplan = ShardingPlan.from_json(plans["decode 1x2"])
        mesh = M.build_mesh(dplan.mesh, "cuda")
        Bd, P, G = MESH_SERVE
        torch.cuda.reset_peak_memory_stats()
        params = T.init_params(cfg, seeded(0))
        prompts = torch.randint(0, cfg.vocab_size, (Bd, P), device="cuda",
                                generator=seeded(2), dtype=torch.int32)
        enc_out = None
        if cfg.is_encoder_decoder:
            frames = torch.randn((Bd, SERVE_FRAMES, cfg.d_model),
                                 generator=seeded(3), device="cuda")
            enc_out = T.encode(cfg, params, frames)
        fa.launches = 0
        dist.barrier()
        t0 = time.perf_counter()
        with M.collective_tally() as tally:
            served = serve.serve_replicated(
                TS.make_decode_step(cfg), params,
                T.init_cache(cfg, Bd, P + G), prompts, G,
                dict(dplan.logical_rules), mesh, enc_out)
        res["serve"] = {
            "s": time.perf_counter() - t0, "rules": dplan.logical_rules,
            "tokens": served.tokens.full_tensor().cpu(),
            "prompt_logits": served.prompt_logits.full_tensor().float().cpu(),
            "prefill_ms": served.prefill_ms, "step_ms": served.step_ms,
            "launches": fa.launches, "calls": dict(tally.calls),
            "bytes": dict(tally.bytes), "steps": P + G - 1,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        del params, served, prompts, enc_out
        torch.cuda.empty_cache()

        # the train steps through the (1, 2) train plan, donated
        opt = AdamConfig(**FAMILY_MESH_OPT)
        applied = ShardingPlan.from_json(plans["train 1x2"]).apply(
            TS.make_train_step(cfg, opt), donate_argnums=0)
        tmesh = applied.mesh
        placements = dict(zip(applied.plan.input_paths,
                              applied.plan.torch_in_placements(tmesh)))
        torch.cuda.reset_peak_memory_stats()
        params = T.init_params(cfg, seeded(0))
        place_in_place(applied, params, "[0][0].params")
        leaves, paths = pytree.flatten_with_paths(params)
        moments = {tree: pytree.unflatten(params, [distribute_tensor(
            torch.zeros(x.shape, dtype=getattr(torch, opt.state_dtype),
                        device="cuda"), tmesh,
            placements[f"[0][0].opt.{tree}{p}"], src_data_rank=None)
            for x, p in zip(leaves, paths)]) for tree in ("m", "v")}
        count = distribute_tensor(
            torch.zeros((), dtype=torch.int32, device="cuda"), tmesh,
            placements["[0][0].opt.step"], src_data_rank=None)
        state = TS.TrainState(params, adam.AdamState(count, moments["m"],
                                                     moments["v"]))
        batch = {k: distribute_tensor(v, tmesh, placements[f"[0][1][{k!r}]"],
                                      src_data_rank=None)
                 for k, v in train_batch(torch, cfg, Bt, St,
                                         seeded(1)).items()}
        del params, leaves, moments
        rows = []
        fa.launches = lru.launches = 0
        ops.local_calls.clear()
        for _ in range(FAMILY_MESH_STEPS):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with M.collective_tally() as tally, ScanProbe() as probe:
                state, m = applied(state, batch)
                torch.cuda.synchronize()
            rows.append({"ms": (time.perf_counter() - t0) * 1e3,
                         "loss": m["loss"].full_tensor().item(),
                         "grad_norm": m["grad_norm"].full_tensor().item(),
                         "calls": dict(tally.calls),
                         "bytes": dict(tally.bytes), "scans": probe.calls})
        res["train"] = {
            "rows": rows, "launches": fa.launches, "rg_lru": lru.launches,
            "local_calls": local_sites(),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        leaves, paths = pytree.flatten_with_paths(state)
        os.makedirs(os.path.join(out_dir, name), exist_ok=True)
        torch.save({"paths": paths,
                    "placements": [[("shard", p.dim) if type(p).__name__ ==
                                    "Shard" else ("replicate",)
                                    if p.is_replicate() else (str(p),)
                                    for p in x.placements] for x in leaves],
                    "locals": [x.to_local().cpu() for x in leaves]},
                   os.path.join(out_dir, name, f"rank{rank}.pt"))
        del applied, state, batch, leaves
        torch.cuda.empty_cache()
        out[name] = res
    return out


def drive_family_mesh(torch, card, seed: int, jobs) -> dict:
    """Phase 7i: ``xlstm_350m``, ``whisper_small`` and ``phi3_vision``,
    each at full width cut to its ``FAMILY_MESH`` depth, on two ranks of
    one gloo group sharing card 0, against one card.

    One card first, per model, eagerly: the prefill request through the
    1x1 plan; the ``MESH_SERVE`` request through ``serve_loop`` (whisper's
    against the encoder's output of its 16 seeded frames);
    ``FAMILY_MESH_STEPS`` train steps from the seeded state on one fixed
    batch (the final state kept on the host) and the same steps with the
    products the train plan splits regrouped as the two ranks regroup
    them (the floor, as 7e measures it), and again in two microbatches
    when the plan splits the positions, batch or sequence (as 6c
    measures it): each leaf's floor the farther of the two runs.  Then one group of two ranks
    (:func:`family_mesh_rank`) runs all three models.  The gathered
    logits within ``LOGITS_REL_TOL`` of one card's largest; the served
    prompt logits too, their argmax equal but in a printed tie; every
    loss and grad norm within ``TRAIN_REL_TOL`` of one card's, every
    leaf within its floor + ``TRAIN_REL_TOL``, the loss falling; the
    attention launches those of the sites; each sLSTM time loop one
    per-shard scan issuing a handful of DTensor ops and collectives (its
    placement moves), not a number per step.

    Args:
        card: the card's name and power limit, for the time lines.
        seed: the seed of the weights, the requests and the batch.
        jobs: model name -> its :func:`family_mesh_job` result.

    Returns:
        Kernel name -> model name -> each rank's launches, for a request
        and for a train step.
    """
    import tempfile

    from repro_torch import pytree
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models import transformer as T
    from repro_torch.optim.adam import AdamConfig
    from repro_torch.train import steps as TS

    t_start = time.perf_counter()
    Bd, P, G = MESH_SERVE
    opt = AdamConfig(**FAMILY_MESH_OPT)

    def seeded(offset):
        return torch.Generator(device="cuda").manual_seed(seed + offset)

    one, floors = {}, {}
    for name, job in jobs.items():
        depth, shape, (Bt, St) = FAMILY_MESH[name]
        cfg = family_cfg(name, depth)
        plan2, tplan = plan_of(job, "1x2"), plan_of(job, "train 1x2")
        dplan = plan_of(job, "decode 1x2")
        keys = ("['R']", "['W']", "['wq']", "['wk']", "['wv']", "['wi']",
                "['wf']")

        def picked(plan, keep):
            return {p: tuple(s) for p, s in zip(plan.input_paths,
                                                plan.in_specs) if keep(p)}
        batch_keys = ("['tokens']", "['frames']", "['patch_embeds']")
        inputs = picked(plan2, lambda p: p.endswith(batch_keys))
        weights = picked(plan2, lambda p: "['enc_layers']" in p and
                         "['mix']" in p or name == XLSTM and
                         p.endswith(keys))
        enc = picked(dplan, lambda p: p == "[0][4]")
        sites = {r["site"]: str(tuple(r["in_specs"][0]))
                 for r in plan2.kernel_sites if r["sharded"]}
        st = job["stats"]
        log(f"[family mesh plan {name} 1x2] {depth} layers"
            + (f" + {depth} encoder layers" if cfg.encoder_layers else "")
            + f", prefill B x S {shape}, train {(Bt, St)}, hbm_per_chip "
            f"{job['hbm'] / 1e9:.3f} GB (each rank's share of the card): "
            f"{job['seconds']:.3f} s to the plans in the worker process; "
            f"sessions " + json.dumps(st) + f"; prefill cost "
            f"{plan2.cost:.6f}, predicted peak "
            f"{plan2.breakdown['peak_bytes'] / 1e9:.3f} GB, inputs "
            + json.dumps(inputs) + ", weights " + json.dumps(weights)
            + ", sharded kernel sites " + json.dumps(sites)
            + f"; train cost {tplan.cost:.6f}, predicted peak "
            f"{tplan.breakdown['peak_bytes'] / 1e9:.3f} GB, rules "
            + json.dumps(tplan.logical_rules) + "; decode rules "
            + json.dumps(dplan.logical_rules)
            + (", enc_out " + json.dumps(enc) if enc else ""))

        # one card: the request on the 1x1 plan, eager; the served request
        params = T.init_params(cfg, seeded(0))
        (request,) = prefill_requests(torch, cfg, seeded(1), shape, 1)
        eager = plan_of(job, "1x1").apply(TS.make_prefill_step(cfg),
                                          capture=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = eager(params, request).float()
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        del eager, request
        prompts = torch.randint(0, cfg.vocab_size, (Bd, P), device="cuda",
                                generator=seeded(2), dtype=torch.int32)
        enc_out = None
        if cfg.is_encoder_decoder:
            frames = torch.randn((Bd, SERVE_FRAMES, cfg.d_model),
                                 generator=seeded(3), device="cuda")
            enc_out = T.encode(cfg, params, frames)
        served = serve.serve_loop(TS.make_decode_step(cfg), params,
                                  T.init_cache(cfg, Bd, P + G), prompts, G,
                                  enc_out)
        one[name] = {"logits": logits.cpu(), "prefill_ms": prefill_ms,
                     "tokens": served.tokens.cpu(),
                     "prompt_logits": served.prompt_logits.float().cpu(),
                     "step_ms": served.step_ms}
        del params, served, prompts, enc_out, logits
        torch.cuda.empty_cache()

        # one card: the train steps, and the same steps regrouped
        def run(fn, label):
            state = TS.init_train_state(cfg, seeded(0), opt)
            batch = train_batch(torch, cfg, Bt, St, seeded(1))
            rows = []
            for _ in range(FAMILY_MESH_STEPS):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                state, m = fn(state, batch)
                end.record()
                torch.cuda.synchronize()
                rows.append({"loss": m["loss"].item(),
                             "grad_norm": m["grad_norm"].item(),
                             "ms": start.elapsed_time(end)})
            log(f"[family mesh train {name} one card, {label}] {card}: "
                f"losses " + json.dumps([round(r["loss"], 6) for r in rows])
                + ", grad norms "
                + json.dumps([round(r["grad_norm"], 6) for r in rows])
                + f", ms {fmt_ms([r['ms'] for r in rows])}")
            host = {p: x.cpu() for x, p in
                    zip(*pytree.flatten_with_paths(state))}
            return host, rows

        one[name]["state"], one[name]["rows"] = run(
            TS.make_train_step(cfg, opt), "eager")
        splits = plan_splits(tplan)
        tokens = tplan.in_specs[tplan.input_paths.index("[0][1]['tokens']")]
        halves = 2 if any(e is not None for e in tokens) else 1
        log(f"[family mesh train {name}] products regrouped for the floor: "
            f"those of {json.dumps(splits)}; the positions split {halves} "
            f"ways (tokens {tuple(tokens)})")
        # the floor: each leaf's farther distance of two such runs, the
        # split products regrouped, then also the positions' gradient sums
        # in halves (two microbatches), as the ranks sum theirs
        floor = {}
        for accum in sorted({1, halves}):
            regrouped, _ = run(regrouped_step(cfg, opt, splits, accum),
                               f"the plan's split products regrouped in "
                               f"halves, {accum} microbatch(es)")
            for p, d in leaf_apart(torch, regrouped,
                                   one[name]["state"]).items():
                floor[p] = max(d, floor.get(p, 0.0))
            del regrouped
        floors[name] = floor
        torch.cuda.empty_cache()

    log(f"[family mesh] before the ranks the parent holds "
        f"{torch.cuda.memory_reserved() / 1e9:.3f} GB reserved")
    launches = {}
    with tempfile.TemporaryDirectory(prefix="family-mesh-") as tmp:
        t0 = time.perf_counter()
        ranks = run_ranks(family_mesh_rank, 2,
                          {n: j["plans"] for n, j in jobs.items()}, seed,
                          tmp, timeout=FAMILY_MESH_TIMEOUT)
        wall = time.perf_counter() - t0
        for name in jobs:
            depth, shape, (Bt, St) = FAMILY_MESH[name]
            cfg = family_cfg(name, depth)
            check_family_mesh(torch, card, name, cfg, ranks, one[name],
                              floors[name],
                              gathered_leaves(torch, os.path.join(tmp, name),
                                              2))
            for kernel, key in (("flash_attention", "launches"),
                                ("rg_lru", "rg_lru")):
                launches.setdefault(kernel, {})[name] = {
                    "request": [r[name]["prefill"][key] for r in ranks],
                    "train_step": [r[name]["train"][key] //
                                   FAMILY_MESH_STEPS for r in ranks]}
    log(f"[family mesh] two ranks, three models: {wall:.1f} s wall, the "
        f"ranks' start included")
    log(f"[elapsed] family mesh phase {time.perf_counter() - t_start:.1f} s")
    return launches


def check_family_mesh(torch, card, name, cfg, ranks, one, floor,
                      far) -> None:
    """Print and check one model's runs on the two ranks of phase 7i
    against one card's (:func:`drive_family_mesh`).  ``far``: the
    ranks' final state made whole, leaf by leaf."""
    from repro_torch.models import transformer as T
    Bd, P, G = MESH_SERVE
    sites = train_sites(cfg)["flash_attention"]
    scans = []
    for rank, res in enumerate(r[name] for r in ranks):
        pf, sv, tr = res["prefill"], res["serve"], res["train"]
        rows = tr["rows"]
        log(f"[family mesh {name} rank {rank}] {card}: request "
            f"{pf['ms']:.1f} ms (one card's eager 1x1 plan "
            f"{one['prefill_ms']:.1f}; host clock, card synchronized; two "
            f"ranks time-sharing one H100 over gloo: not a multi-card "
            f"figure), collectives " + json.dumps(pf["calls"]) + ", bytes "
            + json.dumps(pf["bytes"]) + f", peak {pf['peak_gb']:.2f} GB, "
            f"flash_attention launches {pf['launches']}, local sites "
            + json.dumps(pf["local_calls"]) + ", made whole "
            + json.dumps(pf["made_whole"]))
        log(f"[family mesh serve {name} rank {rank}] {card}: rules "
            f"{json.dumps(sv['rules'])}; {sv['steps']} decode steps: prompt "
            f"{sv['prefill_ms']:.1f} ms, median "
            f"{percentile(sv['step_ms'], 0.5):.2f} ms per generated token "
            f"(CUDA events on the rank; one card's serve_loop "
            f"{percentile(one['step_ms'], 0.5):.2f}); collectives "
            + json.dumps(sv["calls"]) + ", bytes " + json.dumps(sv["bytes"])
            + f"; peak {sv['peak_gb']:.2f} GB; {sv['s']:.1f} s")
        for i, r in enumerate(rows, 1):
            log(f"[family mesh train {name} rank {rank}] step {i}: loss "
                f"{r['loss']:.6f} grad_norm {r['grad_norm']:.6f} "
                f"{r['ms']:.1f} ms (host clock, card synchronized; two "
                f"ranks time-sharing one H100: not a multi-card figure); "
                f"collectives {json.dumps(r['calls'])}, bytes "
                f"{json.dumps(r['bytes'])}")
        log(f"[family mesh train {name} rank {rank}] flash_attention "
            f"launches {tr['launches']} in {len(rows)} steps, local sites "
            + json.dumps(tr["local_calls"]) + f", peak {tr['peak_gb']:.2f} "
            f"GB")
        runs = [("request", pf["scans"])] + [
            (f"train step {i}", r["scans"]) for i, r in enumerate(rows, 1)]
        for label, calls in runs:
            if calls:
                log(f"[family mesh slstm {name} rank {rank}] {label}: "
                    + ", ".join(f"{s:.3f} s, {n} DTensor ops, {c} "
                                f"collectives" for s, n, c in calls)
                    + " per sLSTM layer (forward)")
            scans += [(n, c) for _, n, c in calls]
        n_slstm = sum(k == "slstm" for k in cfg.pattern)
        if len(pf["scans"]) != n_slstm or any(
                len(r["scans"]) != n_slstm for r in rows):
            raise AssertionError(f"{name} rank {rank}: per-shard scans "
                                 f"{[len(r['scans']) for r in rows]}, "
                                 f"expected {n_slstm} a run")
        if pf["launches"] != sites["forward"] or \
                tr["launches"] != sites["launches"] * len(rows):
            raise AssertionError(f"{name} rank {rank}: attention launches "
                                 f"{pf['launches']} / {tr['launches']}, "
                                 f"expected {sites['forward']} a request "
                                 f"and {sites['launches']} a step")
        if sv["launches"] or pf["rg_lru"] or tr["rg_lru"]:
            raise AssertionError(f"{name} rank {rank}: the decode steps "
                                 f"launched attention, or a site the "
                                 f"RG-LRU kernel")
    # a loop that dispatched per step would count thousands (2048 and 512
    # steps): the whole loop runs in one local region
    if any(n > 8 or c > 8 for n, c in scans):
        raise AssertionError(f"{name}: the sLSTM scans dispatched {scans} "
                             f"(DTensor ops, collectives): more than the "
                             f"region's placement moves")
    res = ranks[0][name]
    other = ranks[1][name]
    if not torch.equal(res["prefill"]["logits"], other["prefill"]["logits"]):
        raise AssertionError(f"{name}: the ranks gathered different logits")
    got, want = res["prefill"]["logits"], one["logits"]
    rel = ((got - want).abs().max() / want.abs().max()).item()
    log(f"[family mesh {name}] request: 1x2 on two ranks vs 1x1 on one "
        f"card: max|diff|/max|1x1| = {rel:.3e} (tol {LOGITS_REL_TOL}), "
        f"argmax agree {(got.argmax(-1) == want.argmax(-1)).sum().item()}"
        f"/{got.shape[0]}, finite {bool(torch.isfinite(got).all())}")
    if rel > LOGITS_REL_TOL or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: mesh and one-card logits disagree")
    sv = res["serve"]
    got_l, want_l = sv["prompt_logits"], one["prompt_logits"]
    diff = (got_l - want_l).abs().max().item()
    rel = diff / want_l.abs().max().item()
    top2 = want_l.topk(2, -1).values
    margin = (top2[..., 0] - top2[..., 1]).flatten()
    flipped = (got_l.argmax(-1) != want_l.argmax(-1)).flatten()
    ties = {int(b): round(margin[b].item(), 5)
            for b in flipped.nonzero().flatten()}
    agree = (sv["tokens"] == one["tokens"]).float().mean().item()
    log(f"[family mesh serve {name}] {card}: the launcher's route on two "
        f"ranks vs one card's serve_loop: prompt logits max|diff|/max "
        f"{rel:.3e} (tol {LOGITS_REL_TOL}), argmax equal in "
        f"{Bd - len(ties)}/{Bd} rows"
        + (f" (rows that differ, each with its one-card top-two margin, a "
           f"tie below 2 x max|diff| = {2 * diff:.5f}: {json.dumps(ties)})"
           if ties else "")
        + f", generated tokens equal {agree:.0%}")
    if rel > LOGITS_REL_TOL or any(m > 2 * diff for m in ties.values()):
        raise AssertionError(f"{name}: mesh and one-card serve disagree")
    rows = res["train"]["rows"]
    for key in ("loss", "grad_norm"):
        worst = max(abs(r[key] - o[key]) / abs(o[key])
                    for r, o in zip(rows, one["rows"]))
        log(f"[family mesh train {name}] {key} per step on two ranks "
            + json.dumps([round(r[key], 6) for r in rows])
            + f" vs one card's, worst rel {worst:.3e} (tol {TRAIN_REL_TOL})")
        if worst > TRAIN_REL_TOL or any(
                r[key] != q[key] for r, q in
                zip(rows, other["train"]["rows"])):
            raise AssertionError(f"{name}: two ranks' {key} disagree with "
                                 f"one card's or with each other")
    apart = leaf_apart(torch, far, one["state"])
    for label, keep in (("parameters", lambda p: p.startswith(".params")),
                        ("optimizer state",
                         lambda p: not p.startswith(".params"))):
        top = sorted((p for p in apart if keep(p)), key=apart.get,
                     reverse=True)[:3]
        log(f"[family mesh train {name}] final {label} on two ranks vs one "
            f"card: worst |a-b|/|b| "
            + ", ".join(f"{p} {apart[p]:.3e} (floor {floor[p]:.3e})"
                        for p in top)
            + f"; tol floor + {TRAIN_REL_TOL}")
    worse = beyond(apart, floor)
    if worse:
        raise AssertionError(f"{name}: leaves beyond the regrouping floor: "
                             f"{worse}")
    if not all(math.isfinite(r["loss"]) for r in rows) or \
            rows[-1]["loss"] >= rows[0]["loss"]:
        raise AssertionError(f"{name}: losses {[r['loss'] for r in rows]} "
                             f"not finite or not falling")
    per_step = {k: sum(r["bytes"].get(k, 0) for r in rows[1:]) /
                (len(rows) - 1) for k in rows[-1]["bytes"]}
    log(f"[family mesh time] {card}: {name} request "
        f"{res['prefill']['ms']:.1f} ms a rank, train steps 2-{len(rows)} "
        f"median {percentile([r['ms'] for r in rows[1:]], 0.5):.1f} ms a "
        f"rank (one card eager "
        f"{percentile([o['ms'] for o in one['rows'][1:]], 0.5):.1f}), "
        f"collectives per step {sum(per_step.values()) / 1e9:.4f} GB; "
        f"{T.n_scan_blocks(cfg)} scanned blocks")


def time_lru(lru, torch, gen, card, shape, dtype, route) -> dict:
    """Times one RG-LRU route at ``shape`` beside its bound; logs a
    ``[time]`` line and returns ms, bound and the plain inputs."""
    a, b = lru_inputs(torch, gen, shape, dtype)
    lib = lru.build()
    kernel_ms = cuda_ms(lambda: lru.launch(lib, a, b, route), 20)
    # each input read once, h written once; one multiply-add per element
    nbytes = 3.0 * a.numel() * a.element_size()
    flops = 2.0 * a.numel()
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    bound_ms = max(t_ops, t_bytes)
    log(f"[time] {card}: rg_lru {route} route {shape} {dtype_name(dtype)} "
        f"{kernel_ms:.4f} ms, bound {bound_ms:.4f} ms ({flops / 1e6:.1f} "
        f"MFLOP, {nbytes / 1e6:.2f} MB) -> {bound_ms / kernel_ms:.3%} of "
        f"bound")
    return {"ms": kernel_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "a": a, "b": b}


def main(argv=None) -> int:
    import shutil
    import tempfile

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the train path's weights and batch")
    opts = ap.parse_args(argv)
    t_start = time.perf_counter()
    # the hybrid's train step holds two train states, its gradients and
    # AdamW's f32 temporaries at once (PERF.md section 5): segments that
    # grow in place keep the allocator from fragmenting between steps
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (REPO / "src" / "repro_torch").is_dir():
        print("chip_smoke: run it from the root of a checkout of the "
              "repository (src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # every phase's traces and searches run in two worker processes (meta
    # tensors only) while the card works, in the order the phases need
    # them: at the start the card waits for the first two prefill steps'
    # plans, which one worker took ~80 s to trace and search on a slow host
    pool = concurrent.futures.ProcessPoolExecutor(
        2, mp_context=multiprocessing.get_context("spawn"))
    # the plan store phase's two jobs (7j), each in a process of its own,
    # the second started once the first has returned, beside the pool
    store_dir = tempfile.mkdtemp(prefix="chip_smoke_plans_")
    store_pool = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"),
        max_tasks_per_child=1)
    store_chain = concurrent.futures.ThreadPoolExecutor(1)
    try:
        jobs = {"store": store_chain.submit(store_jobs, store_pool,
                                            store_dir)}
        # the xLSTM phase runs first on the card, while the workers
        # search the first two prefill steps' plans
        jobs["prefill", XLSTM] = pool.submit(plan_job, "prefill", XLSTM,
                                             None, XLSTM_SHAPE)
        jobs["decode", XLSTM] = pool.submit(plan_job, "decode", XLSTM,
                                            DECODE_DEPTH[XLSTM])
        for name, shape in (("qwen2_05b", QWEN_SHAPE),
                            ("recurrentgemma_2b", HYBRID_SHAPE)):
            jobs["path", name] = pool.submit(plan_job, "path", name, None,
                                             shape)
        for name, train in (
                ("qwen2_05b", (TRAIN_SHAPE, TRAIN_OPT, None, None)),
                ("recurrentgemma_2b", (HYBRID_TRAIN_SHAPE, HYBRID_TRAIN_OPT,
                                       None, HYBRID_SMALL_LAYERS))):
            jobs["decode", name] = pool.submit(plan_job, "decode", name,
                                               DECODE_DEPTH[name])
            jobs["train", name] = pool.submit(plan_job, "train", name, None,
                                              *train)
        for name in MOE_DEPTH:
            for kind in ("prefill", "decode"):
                jobs[kind, name] = pool.submit(plan_job, kind, name)
        for name, depth in MOE_DEPTH.items():
            for kind in ("prefill", "decode"):
                jobs[kind, name, depth] = pool.submit(plan_job, kind, name,
                                                      depth)
        for name, depth in MOE_MESH_DEPTH.items():
            jobs["mesh", name, depth] = pool.submit(plan_job, "mesh", name,
                                                    depth)
        for name, depth in MOE_TRAIN_DEPTH.items():
            for d in (depth, None):
                jobs["train", name, d] = pool.submit(
                    plan_job, "train", name, d, MOE_TRAIN_SHAPE,
                    HYBRID_TRAIN_OPT)
        # each of the two ranks' share of the card, TOAST's memory budget
        share = torch.cuda.get_device_properties(0).total_memory / 2
        for name, depth in MOE_MESH_TRAIN_DEPTH.items():
            jobs["mesh train", name, depth] = pool.submit(
                plan_job, "mesh train", name, depth, MOE_MESH_TRAIN_SHAPE,
                MOE_MESH_TRAIN_OPT, share)
        for name, shape in ((WHISPER, WHISPER_SHAPE), (PHI3V, PHI3V_SHAPE)):
            jobs["prefill", name] = pool.submit(plan_job, "prefill", name,
                                                None, shape)
            jobs["decode", name] = pool.submit(plan_job, "decode", name,
                                               DECODE_DEPTH[name], shape)
        for name, (depth, shape, small, remat) in FRONTEND_TRAIN.items():
            jobs["train", name, depth] = pool.submit(
                plan_job, "train", name, depth, shape, TRAIN_OPT, None, small,
                True, remat)
            if depth is not None:
                jobs["train", name, None] = pool.submit(
                    plan_job, "train", name, None, shape, TRAIN_OPT, None,
                    None, False)
        for name in FAMILY_MESH:
            jobs["family mesh", name] = pool.submit(family_mesh_job, name,
                                                    share)
        return run_phases(torch, opts, t_start, jobs)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
        store_pool.shutdown(wait=True, cancel_futures=True)
        store_chain.shutdown(wait=True, cancel_futures=True)
        shutil.rmtree(store_dir, ignore_errors=True)


def run_phases(torch, opts, t_start: float, jobs: dict) -> int:
    """Every phase of the run, in order (see the module docstring);
    ``jobs``: (kind, model) -> the future of its :func:`plan_job`."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import registry
    from repro_torch.kernels import rg_lru as lru

    counters = {"flash_attention": fa, "rg_lru": lru}

    # -- 1: the card and the build ------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    card = card.splitlines()[0]
    log(card)
    kind = torch.cuda.get_device_name(0)
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {kind} x{torch.cuda.device_count()}")
    build_all(counters)

    # -- 2: each kernel against its plain version -------------------------
    qwen = dataclasses.replace(get_config("qwen2_05b"), use_pallas=True)
    hybrid = dataclasses.replace(get_config("recurrentgemma_2b"),
                                 use_pallas=True)
    H, hd = qwen.num_heads, qwen.resolved_head_dim
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    B, S = QWEN_SHAPE
    fa_err = check_fa(fa, torch, gen, B, S, S, H, hd, bf16, True)
    for args in [(2, 200, 333, 4, 64, f32, True),
                 (2, 200, 333, 4, 64, f32, False),
                 (2, 333, 200, 4, 64, bf16, True),
                 (1, 1000, 1000, 2, 64, bf16, True),
                 (1, 1000, 1000, 2, 64, f32, False),
                 (2, 256, 256, 4, 16, f32, True),
                 (2, 256, 256, 4, 16, bf16, True),
                 (2, 256, 256, 4, 128, f32, True),
                 (2, 256, 256, 4, 128, bf16, False),
                 (1, 257, 300, 3, 48, f32, True),
                 (1, 257, 300, 3, 48, bf16, True),
                 (2, 100, 100, 2, 96, bf16, False),
                 (2, 128, 128, 4, 64, bf16, True)]:
        check_fa(fa, torch, gen, *args)
    # S = 1 and T = 1, both ways
    for args in [(1, 1, 1, 2, 64, bf16, True),
                 (1, 1, 300, 2, 64, bf16, False),
                 (2, 300, 1, 2, 128, bf16, True)]:
        check_fa(fa, torch, gen, *args)
    # every head dim the kernel is built for, both dtypes
    for hd_i in sorted(registry.CUDA_HEAD_DIMS):
        for dtype in (f32, bf16):
            check_fa(fa, torch, gen, 1, 130, 130, 2, hd_i, dtype, True)
    for dtype in (f32, bf16):
        check_fa(fa, torch, gen, 2, 190, 190, 4, 64, dtype, True,
                 strided=True)
    # the frontend models' shapes: whisper's 1500 frames (no multiple of
    # the tile) non-causal and causal, phi3_vision's head dim 96
    for args in [(B, WHISPER_FRAMES, WHISPER_FRAMES, 12, 64, bf16, False),
                 (B, WHISPER_FRAMES, WHISPER_FRAMES, 12, 64, bf16, True),
                 (B, S, S, 32, 96, bf16, True)]:
        check_fa(fa, torch, gen, *args)

    # the slice shape: the gates of the hybrid's RG-LRU block, f32
    R = hybrid.d_model * 3 // 2
    lru_shape = (*HYBRID_SHAPE, R)
    a, b = lru_inputs(torch, gen, lru_shape, f32)
    lru_err, h = check_lru(lru, torch, a, b, "slice", "tma")
    # both routes run the same f32 chain in the same order
    if not torch.equal(h, lru.launch(lru.build(), a, b, "generic")):
        raise AssertionError("rg_lru routes disagree at the slice shape")
    log("[kernel] rg_lru slice: TMA and generic routes agree bit for bit")
    check_lru(lru, torch, *lru_inputs(torch, gen, lru_shape, bf16), "slice",
              "tma")
    # rows of 131 channels, and of 300 bf16 channels (600 bytes), are off
    # TMA's 16-byte stride grid: the generic route takes them
    for shape, dtype, route in [((1, 64, 131), f32, "generic"),
                                ((1, 64, 131), bf16, "generic"),
                                ((2, 1000, 300), f32, "tma"),
                                ((2, 1000, 300), bf16, "generic")]:
        check_lru(lru, torch, *lru_inputs(torch, gen, shape, dtype), "edge",
                  route)
    # the model's own gates decay fast (a ~ e^-20): hold the carry with
    # slow gates too
    check_lru(lru, torch, *lru_inputs(torch, gen, lru_shape, f32, 0.9,
                                      0.999), "slow gates", "tma")
    Sd = 2048
    a = torch.full((1, Sd, 128), 0.999, device="cuda")
    b = torch.full((1, Sd, 128), 0.01, device="cuda")
    _, h = check_lru(lru, torch, a, b, "decay", "tma")
    closed = 0.01 * (1 - 0.999 ** Sd) / 0.001
    torch.testing.assert_close(h[0, -1], torch.full_like(h[0, -1], closed),
                               rtol=1e-3, atol=0)
    log(f"[kernel] rg_lru decay: h[S-1] = {h[0, -1, 0].item():.6f}, closed "
        f"form {closed:.6f} (rtol 1e-3) ok")
    # strided views: a and b as the halves of one packed tensor
    packed = torch.rand((2, 300, 2, 256), generator=gen, device="cuda")
    check_lru(lru, torch, packed[:, :, 0], packed[:, :, 1], "strided",
              "tma")

    # -- 7f: xLSTM on the card, while the workers search the first plans --
    log(f"[graphs released] before the xLSTM phase: "
        f"{torch.cuda.memory_reserved() / 1e9:.3f} GB reserved")
    xlstm = drive_xlstm(torch, counters, card,
                        {kind: jobs[kind, XLSTM].result()
                         for kind in ("prefill", "decode")})
    torch.cuda.empty_cache()

    # -- 3: trace both prefill steps; the mesh phase ------------------------
    n_lru = sum(k == "rglru" for k in hybrid.pattern)
    sessions = {cfg.name: jobs["path", cfg.name].result()
                for cfg in (qwen, hybrid)}
    log_session(qwen, QWEN_SHAPE, sessions[qwen.name])
    log_session(hybrid, HYBRID_SHAPE, sessions[hybrid.name])
    mesh = drive_mesh(torch, sessions,
                      {qwen.name: QWEN_SHAPE, hybrid.name: HYBRID_SHAPE},
                      {qwen.name: ("flash_attention", qwen.num_layers),
                       hybrid.name: ("rg_lru", n_lru)}, card)
    log(f"[elapsed] {time.perf_counter() - t_start:.1f} s after the mesh "
        f"phase")

    # -- 4-7: plan and serve each path, prefill then decode; train ----
    fa_launches, _, params, logits = drive_path(
        torch, qwen, sessions[qwen.name], QWEN_SHAPE, counters,
        "flash_attention", qwen.num_layers, card)
    check_mesh(torch, qwen.name, mesh[qwen.name], logits)
    # the first request's logits, which the plan read back from the
    # store in phase 7j must give again
    store_want = logits[0].cpu()
    del logits
    torch.cuda.empty_cache()
    drive_decode(torch, *cut_depth(qwen, params, DECODE_DEPTH[qwen.name]),
                 counters, card, jobs["decode", qwen.name].result())
    del params
    torch.cuda.empty_cache()
    log(f"[graphs released] before the train path: "
        f"{torch.cuda.memory_reserved() / 1e9:.3f} GB reserved")
    train = drive_train(torch, qwen, counters, card, opts.seed, TRAIN_SHAPE,
                        TRAIN_OPT, jobs["train", qwen.name].result())
    torch.cuda.empty_cache()
    launched = dataclasses.replace(qwen, num_layers=LAUNCH_DEPTH)
    whole = drive_launcher(torch, launched, counters, card, opts.seed)
    torch.cuda.empty_cache()
    log(f"[elapsed] {time.perf_counter() - t_start:.1f} s before the mesh "
        f"launcher phase")
    mesh_launch = drive_mesh_launcher(torch, launched, hybrid, whole, card,
                                      opts.seed)
    del whole
    log(f"[elapsed] {time.perf_counter() - t_start:.1f} s after it")
    lru_launches, lru_routes, params, logits = drive_path(
        torch, hybrid, sessions[hybrid.name], HYBRID_SHAPE, counters,
        "rg_lru", n_lru, card)
    check_mesh(torch, hybrid.name, mesh[hybrid.name], logits)
    del logits, sessions
    torch.cuda.empty_cache()
    drive_decode(torch, *cut_depth(hybrid, params,
                                   DECODE_DEPTH[hybrid.name]),
                 counters, card, jobs["decode", hybrid.name].result())
    del params
    torch.cuda.empty_cache()
    log(f"[graphs released] before the train path: "
        f"{torch.cuda.memory_reserved() / 1e9:.3f} GB reserved")
    hybrid_train = drive_train(torch, hybrid, counters, card, opts.seed,
                               HYBRID_TRAIN_SHAPE, HYBRID_TRAIN_OPT,
                               jobs["train", hybrid.name].result(),
                               HYBRID_SMALL_LAYERS)
    torch.cuda.empty_cache()
    log(f"[elapsed] {time.perf_counter() - t_start:.1f} s after the "
        f"{hybrid.name} path")

    # -- 7b: the MoE models, one at a time ---------------------------------
    moe = {}
    for name in MOE_DEPTH:
        log(f"[graphs released] before the {name} phase: "
            f"{torch.cuda.memory_reserved() / 1e9:.3f} GB reserved")
        kinds = ("prefill", "decode")
        moe[name] = drive_moe(
            torch, name, counters, card,
            {kind: jobs[kind, name].result() for kind in kinds},
            {kind: jobs[kind, name, MOE_DEPTH[name]].result()
             for kind in kinds})
        torch.cuda.empty_cache()

    # -- 7c: the MoE models on two ranks sharing the card ------------------
    log(f"[graphs released] before the MoE mesh phase: "
        f"{torch.cuda.memory_reserved() / 1e9:.3f} GB reserved")
    moe_mesh = drive_moe_mesh(
        torch, counters, card,
        {name: jobs["mesh", name, depth].result()
         for name, depth in MOE_MESH_DEPTH.items()})
    torch.cuda.empty_cache()

    # -- 7d: MoE training on the card --------------------------------------
    moe_train = {}
    for name, depth in MOE_TRAIN_DEPTH.items():
        log(f"[graphs released] before the {name} train phase: "
            f"{torch.cuda.memory_reserved() / 1e9:.3f} GB reserved")
        moe_train[name] = drive_moe_train(
            torch, name, counters, card, opts.seed,
            jobs["train", name, None].result(),
            jobs["train", name, depth].result())
        torch.cuda.empty_cache()

    # -- 7e: MoE training on two ranks sharing the card ---------------------
    log(f"[graphs released] before the MoE mesh train phase: "
        f"{torch.cuda.memory_reserved() / 1e9:.3f} GB reserved")
    moe_mesh_train = {}
    for name, depth in MOE_MESH_TRAIN_DEPTH.items():
        moe_mesh_train.update(drive_moe_mesh_train(
            torch, card, opts.seed,
            jobs["mesh train", name, depth].result()))
        torch.cuda.empty_cache()

    # -- 7g: the frontend models on the card ---------------------------------
    frontend = {}
    for name, shape in ((WHISPER, WHISPER_SHAPE), (PHI3V, PHI3V_SHAPE)):
        log(f"[graphs released] before the {name} phase: "
            f"{torch.cuda.memory_reserved() / 1e9:.3f} GB reserved")
        frontend[name] = drive_frontend(
            torch, name, counters, card,
            {kind: jobs[kind, name].result()
             for kind in ("prefill", "decode")}, shape)
        torch.cuda.empty_cache()

    # -- 7h: training the xLSTM and the frontend models ---------------------
    frontend_train = {}
    for name, (depth, *_) in FRONTEND_TRAIN.items():
        log(f"[graphs released] before the {name} train phase: "
            f"{torch.cuda.memory_reserved() / 1e9:.3f} GB reserved")
        frontend_train[name] = drive_frontend_train(
            torch, name, counters, card, opts.seed,
            jobs["train", name, depth].result(),
            None if depth is None else jobs["train", name, None].result())
        torch.cuda.empty_cache()

    # -- 7i: the xLSTM and the frontend models on two ranks sharing it -----
    log(f"[graphs released] before the family mesh phase: "
        f"{torch.cuda.memory_reserved() / 1e9:.3f} GB reserved")
    family_mesh = drive_family_mesh(
        torch, card, opts.seed,
        {name: jobs["family mesh", name].result() for name in FAMILY_MESH})
    torch.cuda.empty_cache()

    # -- 7j: the prefill path's 1x1 plan read back from the plan store ------
    log(f"[graphs released] before the plan store phase: "
        f"{torch.cuda.memory_reserved() / 1e9:.3f} GB reserved")
    store = drive_store(torch, counters, card, jobs["store"], store_want)
    torch.cuda.empty_cache()

    # -- 8: each kernel's time at its slice shape ----------------------------
    log(f"[elapsed] {time.perf_counter() - t_start:.1f} s before the "
        f"kernel times")
    fa_row = time_fa(fa, torch, gen, card, B, S, H, hd, plain=True)
    fa_row.update(launches=fa_launches, max_abs_err=fa_err,
                  launches_train_step=train["launches_per_step"][
                      "flash_attention"],
                  launches_mesh=[r["launches"]["flash_attention"]
                                 for r in mesh[qwen.name]],
                  launches_mesh_train_step=mesh_launch)
    # arctic_480b's sites: (4, 2048, 56, 128)
    arctic = get_config("arctic_480b")
    arctic_row = time_fa(fa, torch, gen, card, *MOE_SHAPE, arctic.num_heads,
                         arctic.resolved_head_dim, plain=True)
    fa_row["launches_moe"] = {k: v["launches"] for k, v in moe.items()}
    fa_row["launches_mesh_moe"] = moe_mesh
    fa_row["launches_moe_train_step"] = {
        k: v["launches_per_step"]["flash_attention"]
        for k, v in moe_train.items()}
    fa_row["launches_moe_train_mesh"] = moe_mesh_train
    fa_row["launches_xlstm"] = xlstm["launches"]["flash_attention"]
    fa_row["launches_whisper"] = frontend[WHISPER]["launches"]
    fa_row["launches_phi3_vision"] = frontend[PHI3V]["launches"]
    for name, key in ((WHISPER, "whisper"), (PHI3V, "phi3_vision"),
                      (XLSTM, "xlstm")):
        fa_row[f"launches_{key}_train"] = frontend_train[name][
            "launches_per_step"]["flash_attention"]
        fa_row[f"launches_{key}_mesh"] = family_mesh["flash_attention"][name]
    fa_row["launches_store"] = store["launches"]["flash_attention"]
    # the frontend models' sites: whisper's encoder (4, 1500, 12, 64)
    # non-causal and its decoder causal; phi3_vision's (4, 2048, 32, 96)
    whisper, phi3v = get_config(WHISPER), get_config(PHI3V)
    for key, (cfg_i, S_i, causal, errs) in {
            "whisper_encoder_shape": (whisper, WHISPER_FRAMES, False,
                                      frontend[WHISPER]),
            "whisper_decoder_shape": (whisper, WHISPER_SHAPE[1] // 2, True,
                                      frontend[WHISPER]),
            "phi3_vision_shape": (phi3v, PHI3V_SHAPE[1], True,
                                  frontend[PHI3V])}.items():
        row = time_fa(fa, torch, gen, card, B, S_i, cfg_i.num_heads,
                      cfg_i.resolved_head_dim, plain=True, causal=causal)
        fa_row[key] = {
            "shape": [B, S_i, cfg_i.num_heads, cfg_i.resolved_head_dim],
            "causal": causal,
            "max_abs_err": errs["site_errs"][
                "causal" if causal else "non-causal"],
            **{k: row[k] for k in ("ms", "plain_ms", "bound_ms",
                                   "bound_by", "library_ms")}}
    fa_row["arctic_shape"] = {
        "shape": [*MOE_SHAPE, arctic.num_heads, arctic.resolved_head_dim],
        "max_abs_err": max(moe["arctic_480b"]["site_errs"]),
        **{k: arctic_row[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms")}}
    # the head dims of the repo's other configs, at the slice's B, S, H
    for hd_i in (96, 128):
        time_fa(fa, torch, gen, card, B, S, H, hd_i, plain=False)
    # the inner loop without the causal tail: no mask, and a longer S
    time_fa(fa, torch, gen, card, B, S, H, hd, plain=False, causal=False)
    time_fa(fa, torch, gen, card, 1, 4 * S, H, hd, plain=False)

    # the RG-LRU ring at the slice shape (the main path's route), in bf16
    # and at one batch row; the generic route at the slice shape
    ring = time_lru(lru, torch, gen, card, lru_shape, f32, "tma")
    a, b = ring["a"], ring["b"]
    if lru.route(a, b) != "tma":
        raise AssertionError("the slice shape does not take the TMA ring")
    plain_ms = cuda_ms(lambda: lru.reference(a, b), 5)
    log(f"[time] {card}: rg_lru plain {lru_shape} float32 {plain_ms:.4f} ms")
    time_lru(lru, torch, gen, card, lru_shape, bf16, "tma")
    # the hybrid train step's shape (B 1): the forward kernel, and the
    # backward (the plain scan's vjp, the one implementation)
    train_ring = time_lru(lru, torch, gen, card, (1, *lru_shape[1:]), f32,
                          "tma")
    a1, b1 = train_ring["a"], train_ring["b"]
    bwd_ms = cuda_ms(lambda: lru.reference_bwd(a1, b1, b1), 5)
    log(f"[time] {card}: rg_lru_bwd plain vjp {tuple(a1.shape)} float32 "
        f"{bwd_ms:.4f} ms per call (the train step's backward sites)")
    del a1, b1, train_ring
    generic = time_lru(lru, torch, gen, card, lru_shape, f32, "generic")
    log(f"[time] {card}: rg_lru ring ({lru.TILE_BYTES} channel bytes x "
        f"{lru.BOX_S} steps per box, {lru.STAGES} stages, {lru.OUT_BOXES} "
        f"h boxes) / generic route at the slice shape {ring['ms']:.4f} / "
        f"{generic['ms']:.4f} ms = {generic['ms'] / ring['ms']:.2f}x faster")
    lru_row = {
        "name": "rg_lru", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rg_lru.cu",
        "replaces": "src/repro/kernels/rg_lru.py:30",
        "launches": lru_launches, "max_abs_err": lru_err,
        "ms": ring["ms"], "plain_ms": plain_ms,
        "bound_ms": ring["bound_ms"], "bound_by": ring["bound_by"],
        "library_ms": None,
        "launches_train_step": hybrid_train["launches_per_step"]["rg_lru"],
        "launches_mesh": [r["launches"]["rg_lru"] for r in mesh[hybrid.name]],
        "launches_xlstm": xlstm["launches"]["rg_lru"],
        "launches_whisper": 0, "launches_phi3_vision": 0,
        **{f"launches_{key}_train": frontend_train[name][
            "launches_per_step"]["rg_lru"]
           for name, key in ((WHISPER, "whisper"), (PHI3V, "phi3_vision"),
                             (XLSTM, "xlstm"))},
        **{f"launches_{key}_mesh": family_mesh["rg_lru"][name]
           for name, key in ((WHISPER, "whisper"), (PHI3V, "phi3_vision"),
                             (XLSTM, "xlstm"))},
        "launches_store": store["launches"]["rg_lru"]}

    log(f"[routes] rg_lru launches by route on the {hybrid.name} path: "
        + json.dumps(lru_routes))
    log(f"[total] chip_smoke.py ran {time.perf_counter() - t_start:.1f} s, "
        f"the build included")
    log(json.dumps({"kernels": [fa_row, lru_row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
