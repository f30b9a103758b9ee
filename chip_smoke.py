#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):

1. build every CUDA kernel of the port from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all started together);
2. hold each kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it (plus ragged, ``d_live``, bf16, GQA,
   window, ``q_offset``, rows without keys and SSD chunk-size cases,
   hessian_accum's splits of N, unaligned inputs and bit-identical
   repeats, the whole chunked SSD scan against the token-by-token
   recurrence, and the SSD backward kernel against its plain version at
   the forward's cases, fp32 and bf16 B/C, and bit for bit), and time
   kernel, plain version and, where one exists, the
   single PyTorch call that computes the same function, each by CUDA
   events around eager calls (hessian_accum at all three widths of its
   paths; flash attention also at the serving buckets 128-512 and at 8
   prompts of 1024, and by CUDA graph replay as well: its kernel takes
   tens of microseconds, less than its wrapper's host path; the SSD pass
   at the calibration batch's 80 heads and at 40 and 16, eager and by
   graph replay; its backward at a train step's shape, eager and by graph
   replay); phase 7's shapes too: hessian_accum over one expert's
   dispatch slots at d_ff 6400 with the unfilled rows zeroed,
   obs_downdate over a layer's 16 experts (16, 6400, 4096, gs 1, also
   timed), flash
   attention with 32 query heads on 8 KV heads of 128 at the serving
   buckets 128-512; and phase 13's: the SSD pass and its backward at
   Hymba-1.5B's (8, 2, 256, 25, 64, 16) (checked, bit for bit, timed),
   flash at (1, 4096, 4096, 25, 5, 64) with a 1024-token window and at
   the two query chunks the model launches for it (checked; timed beside
   ``scaled_dot_product_attention`` with the boolean mask, and beside the
   same shape causal without the window); and phase 14's: hessian_accum
   over bf16 X at Whisper's D = 1280 and 5120 (N = 4096, with an
   accumulator; timed beside ``torch.addmm`` with ``out_dtype``) and
   obs_downdate over its decoder's (4, 5120, 1280) FFN stack (checked,
   timed); and phase 15's: hessian_accum at Llama-3.2-Vision's D = 4096
   and 14336 (N = 4096 with an accumulator, fp32 as the path feeds it
   and bf16 beside ``addmm`` with ``out_dtype``) and obs_downdate over
   its (5, 14336, 4096) gs-1 FFN stack and (5, 4096, 4096) gs-512
   attention stack (checked, timed);
3. check the slices on small models: the card's run (kernels) against the
   CPU run (plain versions) on the same weights and Hessians, a 2-layer
   model's prefill logits and served tokens, ``runtime.device.to_host``
   (the databases' and checkpoints' staged copy to host memory) equal to
   ``.cpu()`` bit for bit at the edges of its chunks, a 2-layer Mamba-2's
   logits, Hessians, database errors, greedy tokens and one train step's
   loss and gradients (the SSD forward and backward kernels), the same
   for the reference's smoke Hymba (2 layers, attention and SSD heads
   side by side), the reference's smoke Whisper (2 encoder and 2
   decoder layers, its cross-attention gates opened: logits, Hessians,
   database orders, greedy tokens through the cross cache), the same for
   the reference's smoke Llama-3.2-Vision (2 self layers and 1 cross
   group) and a variant with two cross groups and ``frontend_proj``
   (frames of 96), and the
   reference's smoke Phi-3.5-MoE (2 layers, 4 experts top-2) in both MoE
   prune modes: logits, Hessians, database errors, member losses and
   served tokens; and 5 steps of ``make_train_step`` on the small GPT-2
   (the dense model as teacher, a member's masks, 2 microbatches): every
   metric within 1e-3 relative, the masked rows exactly 0 on both;
4. the main path: ``oneshot_prune`` on full-width GPT-2 small (6 of its
   12 layers, d_model 768, 12 heads, d_ff 3072, vocab 50257; phases 5, 8
   and 9 run the same model) with seeded weights,
   numpy calibration batches, a latency table measured on the card and
   targets 1.5x/1.53x/1.56x (the 2x and 3x the phase ran before lie above
   the table's 1.7465x ceiling, its dense runtime over the logits head;
   the ceiling is printed and held to 0.95 of that, ``check_ceiling``, as
   in phases 13 and 14). The
   table times each module by one replay of a CUDA graph of its 50
   calls, the card's time and not its launches. The kernels' launch counts are
   zeroed just before and read just after; each kernel must have
   launched. Then the family is searched again on the same database and
   table by the analytic
   prior sum, which must give one member per target with rising
   speedups (on random weights the loss-scored family can collapse to
   one member), and the table is rebuilt twice to show its spread;
5. serving at full width: the prior-scored family of phase 4 (three
   shrunk GPT-2 small members and the dense model, bf16, ``max_len``
   1024) stood up by a ``FamilyServer`` from the stock config (the
   engines prefill through the flash-attention kernel whatever
   ``attn_impl`` says); shrink and stitched-model checks, then every
   member serves one seeded stream (32 requests, 8 slots, prompts of
   128-768 tokens, 16-64 generated tokens, 50 req/s) and the routed
   stream runs through ``FamilyServer.run``, with the launch counts
   zeroed just before and read just after; engine tokens against
   per-request decoding, KV bytes against the shrunk structures; then
   the serving CLI (``repro_torch.launch.serve --arch gpt2-small``) as a
   user runs it, which must launch the flash kernel too;
8. (run right after phase 5, on phase 4's dense model, database and
   prior-scored family) the distillation trainer: the top member
   (1.56x, the most structures removed) stitched,
   masked by ``masks_from_assignment`` and finetuned against the dense
   model with the reference's gradual defaults (lr 8e-5, 5 warm-up steps,
   40 steps, logit 1.0 and token 0.5 distillation) on batches of 8 x 512,
   checkpoints every 20 steps. Run A takes 40 steps; run B stops at 30 and
   a new trainer resumes from its step-20 checkpoint to 40: params, m, v
   and count equal to run A's bit for bit. Masked rows exactly 0 after A
   and in the restored checkpoint; A's member shrunk against its masked
   forward; then, with the launch counts zeroed before run A and read
   after, the Hessians and the database rebuilt on A's member (the
   already-removed structures must come first in every new removal
   order, at error 0); last the training CLI (``python -m
   repro_torch.launch.train --arch gpt2-small --steps 10 --batch 8 --seq
   512``) must exit 0. Prints the median step time, tokens/s, peak
   memory, the checkpoint's bytes and its save and restore seconds;
9. (run right after phase 8, on the first 2 layers of phase 4's dense
   model and its calibration) the gradual family engine:
   ``gradual_prune`` for targets 1.3x and 1.5x,
   each target calibrated again, its database built, searched (16
   candidates, population 8, scored by loss), finetuned 16 steps of 8 x
   512 with the reference's gradual defaults and a checkpoint at step 8
   (``keep_checkpoints=False``: none at a finetune's end, and each
   target's removed once its finetune has returned), and exported on a
   background thread (``overlap=True``); priced
   by the cost model on the H100 data sheet's rates (a measured table is
   not the same in two builds, so a resume would search against another
   one). Run A goes through, with the launch counts zeroed just before
   and read just after (hessian_accum and obs_downdate must each have
   launched; JSON ``family_launches``). Run B is killed after target 0's
   search, then at step 12 of target 1's finetune (its step-8
   checkpoint must be on disk), then resumed to the end, executing only
   target 1's finetune: assignments, speedups, losses and final params
   equal to run A's bit for bit. Every member meets its target, the
   speedups rise, masked rows are exactly 0 and each shrunk member's
   logits are within 5e-2 of scale of its masked model's. Prints each
   target's stage seconds, both runs' seconds, the bytes of each artifact
   kind and the peak device memory;
6. the Mamba-2 slice: ``oneshot_prune`` on Mamba-2 2.7B at full width
   (d_model 2560, 80 SSD heads x 64, state 128, chunk 128, vocab 50280)
   with 6 of its 64 layers, seeded weights, the same calibration, table
   and search as phase 4 and targets 1.25x/1.5x/2x, with the launch
   counts zeroed just before and read just after (the SSD kernel,
   hessian_accum and obs_downdate must each have launched); the
   prior-scored family, each member shrunk (``shrink`` ==
   ``shrink_from_stitched``) and run against its stitched model; then the
   dense model generates from 512-token prompts (prefill through the SSD
   kernel, then the recurrent decode);
10. (run right after phase 6) gradual ZipLM on Mamba-2: ``gradual_prune``
   on Mamba-2 2.7B at full width with 1 of its 64 layers and seeded
   weights, targets 1.15x and 1.3x (the cost-model table's dense split is
   printed first: at 1 layer the logits head is most of it), phase 9's
   search, gradual defaults, cost-model table and batches, 8 finetune
   steps a target with a checkpoint at step 4 (``keep_checkpoints=False``
   as in phase 9), ``overlap=True``. Run A goes
   through, with the launch counts zeroed just before and read just after
   (the SSD forward and backward kernels, hessian_accum and obs_downdate
   must each have launched; JSON ``ssm_family_launches``); a train step
   of the first member against the dense teacher is timed apart (median
   ms, tokens/s, one backward launch a layer); run B is killed at step 4
   of target 1's finetune and resumed: assignments, speedups, losses and
   every param equal to run A's bit for bit, the resume executing only
   that finetune. Every member meets its target, masked rows are 0 and
   each shrunk member's logits are within 5e-2 of scale of its masked
   model's. Prints stage seconds, both runs' seconds, artifact bytes and
   the peak device memory;
7. the MoE slice: Phi-3.5-MoE at full width (d_model 4096, 32 query heads
   on 8 KV heads of 128, 16 experts top-2 of d_ff 6400, vocab 32064) with
   1 of its 32 layers, seeded weights and phase 4's calibration, table
   and search. The calibration Hessians are collected once; then
   ``oneshot_prune`` in width mode and, from the same Hessians, in expert
   mode (each expert kept or dropped whole), targets 1.25x/1.5x/2x. Each
   mode's members are shrunk (``shrink`` == ``shrink_from_stitched``)
   and run against their stitched models, and a ``FamilyServer`` serves a
   seeded stream (8 requests, 8 slots, prompts of 128-512 tokens, 16-32
   generated tokens) through every member with flash prefill; engine
   tokens against per-request decoding in fp32; last the dense model
   generates. The launch counts are zeroed before the calibration and
   read after the last step: hessian_accum, obs_downdate and
   flash_attention must each have launched. It prints each stage's
   seconds, the peak device memory, the snapshots' bytes and the seconds
   of their round trip through host memory.
11. (run right after phase 7, on its dense model and calibration batches)
   gradual ZipLM on Phi-3.5-MoE in expert mode: ``gradual_prune`` to
   1.3x and 1.6x on the cost-model table of phases 9 and 10 (its share
   that no unit can remove, and the ceiling it implies, printed first),
   4 finetune steps a target of 8 x 512 with the gradual defaults and
   no checkpoint (``keep_checkpoints=False`` writes none at a finetune's
   last step, and every 4 steps is that step), search 16 candidates in
   populations of 8,
   ``overlap=True``; the launch counts zeroed just before and read just
   after (hessian_accum must have launched, flash_attention must not:
   attention is dense at 512 tokens; JSON ``moe_family_launches``). Every
   member meets its target, drops experts whole, keeps its masked rows (a
   dropped expert's ``wd`` rows, a removed KV group's ``wo`` rows) at 0
   after the finetune, and its shrunk model's logits are within 5e-2 of
   scale of its masked model's (no token dropped on the masked side).
   Then the last member's train step (dense teacher, its masks) is run
   twice for 2 steps from one state: params, m and v bit-equal (digests,
   ``state_digest``). Prints each target's stage seconds, the run's
   seconds, the peak device memory and the bytes of each artifact kind;
12. two of the port's examples on the card through their ``main`` with
   their defaults: ``examples/torch_quickstart.py`` and
   ``examples/torch_oneshot_prune_arch.py --arch phi3.5-moe-42b-a6.6b``;
   every member meets its target, and hessian_accum and obs_downdate
   launch.
13. the hybrid slice: ``oneshot_prune`` on Hymba-1.5B at full width
   (d_model 1600, 25 query heads on 5 KV heads of 64 with a 1024-token
   window beside 25 SSD heads of 64, state 16, chunk 256, d_ff 5504,
   vocab 32001 tied) with 4 of its 32 layers, seeded weights, phase 4's
   calibration and search, a measured table (its ceiling printed and held
   to 0.95 of 1.9388x) and targets 1.25x/1.5x/1.72x (2x lies above the
   ceiling), with the launch counts zeroed just before
   and read just after (hessian_accum, obs_downdate and the SSD kernel
   must each have launched); the prior-scored family, each member shrunk
   (``shrink`` == ``shrink_from_stitched``, removed rows 0) and run
   against its stitched model; then one full-width hybrid layer's
   forward at 4096 tokens, where ``attn_impl="auto"`` launches flash,
   against dense attention (2e-2 of scale). Prints the stage seconds, the
   peak, the snapshots' bytes and round trip and the launches (JSON
   ``hybrid_launches``).
14. the encoder/decoder slice: ``oneshot_prune`` on Whisper-large-v3 at
   full width (d_model 1280, 20 heads of 64, d_ff 5120, vocab 51866
   tied; the encoder at 8 of its 32 layers over (8, 1500, 1280) frame
   embeddings, 4 of the 32 decoder layers), seeded weights with the
   cross-attention gates drawn so that their tanh lies in [0.5, 0.9],
   phase 4's calibration (each batch with its frames), measured table
   and search, targets 1.25x/1.5x/1.67x (2x lies above the table's
   ceiling, printed and held to 0.95 of 1.8796x). Only the decoder's
   units are pruned and priced. Checks: every target met, removed rows 0, finite
   losses, the logits of the dense model and the top member moved by
   other frames, and greedy decoding of 8 tokens through
   ``generate(frontend=...)`` and the cross cache in fp32, each step's
   logits within 2e-3 + 1e-2 of the full forward's, on the dense model
   and the top member; hessian_accum and obs_downdate launched (JSON
   ``encdec_launches``). Prints stage seconds, peak, snapshot bytes and
   their round trip, launches and each member's removals.
15. the grouped cross-attention slice: ``oneshot_prune`` on
   Llama-3.2-Vision-11B at full width (d_model 4096, 32 heads on 8 KV
   heads of 128, d_ff 14336, vocab 128256 tied) with one cross group: 5
   self layers and the cross module after them over (8, 1601, 4096)
   patch embeddings, seeded weights drawn on the card with the gate drawn
   so that its tanh lies in [0.5, 0.9], phase 4's calibration (each
   batch with its frames), measured table and search, targets
   1.25x/1.5x/2x (the table's ceiling printed and held to 0.95 of
   ``VLM_CEILING``). Only the self layers' units are pruned and priced;
   every member keeps the dense cross module. Checks as phase 14's, the
   decoding through ``generate(frontend=...)`` and the grouped cross
   cache (JSON ``vlm_launches``).
16. latency and search. (b) and (c) run right after phase 4, on its
   database and measured table: the serial SPDY search
   (``search_family(batched=False)``) against the batched one for
   phase 4's targets, bit for bit on the analytic score and within 1e-6
   relative scored by the calibration loss (serial ``eval_fn`` against
   batched ``eval_batched``), and the loss-scored search placed over
   ``["cuda:0", "cuda:0"]`` (a stream a list position, a thread a
   target's partition) bit for bit the batched one (assignments, scores,
   histories, ``n_evals``), each search's seconds printed; phase 4's
   measured table built through the
   persistent latency cache in a temporary directory and built again (a
   hit: no timed call, the same table bit for bit, a key that names the
   card, the search's assignments unchanged), each build's seconds
   printed. (a) runs after phase 15, on the first self layer of its
   Llama-3.2-Vision-11B: the FFN module (14336 rows, gs 1) and the
   KV-group module (8 groups of 512 rows) each built by
   ``build_module_db`` on the plain and on the live-set-compacted route,
   their orders equal, errors within 1e-5 relative, snapshots within one
   float16 rounding, the compacted ``perm`` covering the live set; the
   downdate's launches with ``d_live`` below the working rows counted on
   the path, and the kernel checked and timed at the first and the last
   compacted FFN widths (JSON ``compact_launches``, and two
   ``other_shapes`` rows of obs_downdate).
17. robustness (run right after phase 5, on phase 4's GPT-2 small, its
   calibration, database and measured table, and phase 5's top member),
   each part under its own fault plan and report scope: (a)
   ``calib.batch:nan@1``, the Hessians bit-equal to a clean
   ``collect_hessians`` without batch 1, one batch detected and
   recovered; (b) ``obs.cholesky:nan@0``, the database healed at rung 1,
   its attention chunk equal to a clean build at damp x 10 and its FFN
   chunk to phase 4's database (orders, errors, snapshots bit for bit);
   (c) ``kernel.pallas:raise@0``, ``oneshot_prune`` raises
   ``FaultInjected`` out of its first kernel call, no breaker opens and
   no launch is counted; (d) ``spdy.batched_eval:raise@0``, the search
   demoted once to serial scoring gives the clean batched search's
   assignments and scores; (e) ``latency.measure:raise@0`` with a
   cached entry, the call returns the cost-model table priced with
   ``H100_SXM``, the entry quarantined, one demotion; (f)
   ``serve.step:nan@2,serve.step:raise@5`` on the top member in fp32,
   the clean run's tokens, 2 detected and 2 recovered; (g) a gradual
   family on 2 full-width layers, clean and under
   ``db.artifact_write:corrupt@0,ckpt.async_write:oserror@0x2`` (killed
   after its Hessians, resumed: the corrupted Hessians quarantined and
   rebuilt, the first checkpoint write healed on its third attempt), bit
   for bit the clean member. Seconds per part and JSON
   ``chaos_launches``. After the last phase the process's default
   robustness report holds no injection, open breaker or demotion, and
   no report counted an injection or a demotion outside phase 17.
18. the sharded calibration and database, the mesh trainer and the
   family over ranks (run right after phase 4, on its GPT-2 small,
   calibration batches and database): two ranks share the card through
   ``launch.subproc.run_ranks`` (gloo groups staged through host
   memory), each rebuilds phase 4's weights and tokens from their seeds
   and shows the parent's digests of them; the parent's references of
   (d) and (f) run beside the ranks, which wait for the files the parent
   hands them. (a)
   ``collect_hessians(mesh=...)`` within 1e-5 of max |H| of a clean
   single-process ``collect_hessians`` in the parent; (b)
   ``build_database(mesh=...)`` fed the parent's Hessians, phase 4's
   database bit for bit (orders, errors, snapshots); (c) (b) under
   ``db.sharded_group:raise@0``: the first chunk demoted on both ranks,
   the breaker tripped once, (b)'s database bit for bit; (d)
   ``oneshot_prune(mesh=...)`` fed the parent's Hessians (as (b) is:
   sharded Hessians are within 1e-5, not bit for bit, and a loss score
   would see that), on the cost model priced with ``H100_SXM``, scored
   by the calibration loss, phase 4's targets, its search placed over
   the ranks (rank r scores the new candidates of the targets k with k
   % 2 == r, one all-gather a round): the parent's single-process call's
   assignments, speedups, scores, histories and ``n_evals`` on both
   ranks, the ranks' scored candidates summing to ``n_evals``; (e) (d)
   with ``spdy.batched_eval:raise@0`` installed on rank 0 only: both
   ranks demote once in the first round (no all-gather), one injection
   on rank 0, (d)'s family; (f) the mesh trainer
   (``Trainer(mesh=, specs=)``, FSDP slices of params, m, v and the
   teacher) on phase 4's model, 6 steps of 8 x 256 tokens in 2
   microbatches, distilled (logit 1.0, token 0.5) from a second seeded
   draw at lr 3e-7 (``MESH_TRAIN`` says why), held by the reference's
   bounds: params within 1e-4 of the parent's single-process trainer on
   the same inputs, and each step's loss within 1e-3 of the
   single-process loss of the same params and batch; and by what grows
   with the work: the trajectories' losses within 0.1 of each other,
   each step's gradient norm within 1e-3 of the parent's, relative, and
   the update over the 6 steps within 0.05 of the parent's, relative
   (limits between the sound run and planted faults, ``MESH_TRAIN``);
   ``logit_kl`` above 0 every step, each rank holding only its slices
   of params, m and v; (g) the same with
   ``grad_compression="int8_ef"``: one residual row a rank, nonzero and
   changed at every step, the last loss within 0.15 of (f)'s; (h)
   ``gradual_prune(mesh=, specs=)`` as phase 17 (g) (the first 2
   layers, 1.3x on the cost model, 8 finetune steps of 4 x 256) run
   through, then killed at step 4 of its finetune and resumed on both
   ranks: bit-equal (digests of assignment, speedup, losses and params;
   the manifests' artifact digests), hessian_accum and obs_downdate
   launched on each rank, and no write under the run directories from
   rank 1 (rank 0's writes are counted by the same audit). Seconds per
   part, each rank's scored candidates and all-gathers, the calls,
   bytes and seconds each collective staged in each part, and JSON
   ``sharded_launches`` (each rank's launches of hessian_accum and
   obs_downdate over (a)-(h), all above 0).

TF32 is switched off for matmuls and cuDNN, so every fp32 product on the
card is a full fp32 product and the fp32 tolerances below hold. The train
step runs under deterministic algorithms, which need
``CUBLAS_WORKSPACE_CONFIG`` before the first cuBLAS call: it is set first.

Prints the card's name and power limit, per-kernel numbers and stage
times, then one JSON line of kernels and, last, the device JSON line.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# H100 SXM data sheet (dense, 700 W): fp32 outside the tensor cores, bf16
# and TF32 on the tensor cores, and device memory bandwidth
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
HBM_BYTES_PER_S = 3.35e12
# the GPT-2 small phases (4, 5, 8 and 9) run 6 of its 12 layers at full
# width: with phases 11 and 12 added the script took 1302 s of its 1200 s
# at 12 layers on an NVIDIA H100 80GB HBM3 at 700 W. The serving and
# training CLIs of phases 5 and 8 run the whole model. With phase 13 added
# the script took 1209 s on a host that ran the older phases 16% slower
# than before, so phase 5 served 64 requests (not 128) and phase 10 runs
# 1 Mamba-2 layer (not 2). With phase 15 added it took 1155 s, so phase 5
# serves 32 requests, phase 6 runs 6 Mamba-2 layers (not 8), phase 7
# serves 8 requests a member (not 16), phase 9 ran 4 GPT-2 layers and
# phase 14 8 encoder layers (not 32); phase 9 runs 2 since phase 18 runs
# the mesh trainer and a family over ranks (FAMILY_LAYERS)
MAIN_LAYERS = 6
# phase 4's targets. Timed by device time, GPT-2 small's 6 layers leave
# the unaligned 2048 x 768 x 50257 logits head more than half of the dense
# runtime: the measured table's ceiling is 1.7465x (NVIDIA H100 80GB
# HBM3, 700 W), so the 1.5x target stays and the 2x and 3x ones, above the
# ceiling, became 1.53x and 1.56x, spaced up to 0.9 of it. Phase 8
# finetunes the top member
MAIN_TARGETS = [1.5, 1.53, 1.56]
MAIN_CEILING = 1.7465
# the main path's measured latency table: each module level the mean of
# 50 calls after 5 untimed ones
LATENCY_KW = {"reps": 50, "warmup": 5}
# kernels the one-shot path (phase 4), the serving path (phase 5) and the
# Mamba-2 path (phase 6) run
ONESHOT_KERNELS = ("hessian_accum", "obs_downdate")
SERVING_KERNELS = ("flash_attention",)
SSM_KERNELS = ("ssd_intra_chunk", "hessian_accum", "obs_downdate")
MOE_KERNELS = ("hessian_accum", "obs_downdate", "flash_attention")


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


def check(ok: bool, what: str) -> None:
    """A failed check fails the phase (kept under ``python -O`` too)."""
    if not ok:
        raise AssertionError(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Device milliseconds per call: CUDA events around ``reps`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 20) -> float:
    """Device milliseconds per call with the host out of the way: ``reps``
    calls captured in one CUDA graph, replayed between CUDA events. For a
    kernel of tens of microseconds, where an eager loop would time the
    host's launch path instead."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (3 * reps)


def bound_ms(bytes_: float, ops: float, peak_ops: float):
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# hessian_accum: N = 8 x 512 calibration tokens, D = GPT-2 small's d_ff
# (wd_in) and d_model (wo_in) and Mamba-2 2.7B's d_inner, each with the
# running Hessian as accumulator; then the kernel's other branches: splits
# of N, a D that is not a multiple of 4, a base that is not 16-byte
# aligned (the 4-byte copies), N below one strip, bf16 for each.
# (n, d, dtype name, acc, offset view)
HESSIAN_CASES = [(n, d, dt, acc, off) for dt in ("float32", "bfloat16")
                 for n, d, acc, off in [
                     (4096, 3072, True, False), (4096, 768, True, False),
                     (4096, 5120, True, False), (8192, 256, True, False),
                     (257, 131, True, False), (513, 300, True, False),
                     (1000, 200, True, True), (5, 96, True, False),
                     (4096, 768, False, False)]]
HESSIAN_BITWISE = [(4096, 768), (4096, 3072)]
# one expert's dispatch slots in phase 7's calibration (capacity 640 of 8 x
# 512 tokens, top-2 of 16 experts) at Phi-3.5-MoE's d_ff; the slots no
# token filled are zero rows (``core.hessian.xtx``)
HESSIAN_MASKED = [(640, 6400)]
# timed, fp32 with an accumulator: the main path's shape first, then
# Llama-3.2-Vision's self layers (phase 15), one calibration batch of 8 x
# 512 tokens into wo_in (d_model 4096) and wd_in (d_ff 14336): the
# one-shot path's captures reach the kernel in fp32 (``core.hessian.xtx``)
HESSIAN_TIMED = [(4096, 3072), (4096, 768), (4096, 5120), (4096, 4096),
                 (4096, 14336)]
# timed, bf16 with an accumulator: Whisper-large-v3's decoder (phase 14)
# wo_in (d_model 1280) and wd_in (d_ff 5120), and Llama-3.2-Vision's
HESSIAN_TIMED_BF16 = [(4096, 1280), (4096, 5120), (4096, 4096),
                      (4096, 14336)]


def hessian_close(got, want, n):
    """The reference's accumulator tolerance, 1e-4 * sqrt(N) abs + 1e-4
    rel (a bf16 input converts exactly to fp32 on both sides, so it holds
    there too): (max abs error, within it, atol)."""
    atol = 1e-4 * math.sqrt(n)
    diff = (got - want).abs()
    return (float(diff.max()), bool((diff <= atol + 1e-4 * want.abs()).all()),
            atol)


def time_hessian(torch, kernel, plain, g, cases, dtype=None):
    """Time ``kernel`` (X in ``dtype``, fp32 by default, with an fp32
    accumulator) at each (N, D) of ``cases`` beside ``plain`` (its plain
    version) and ``torch.addmm(acc, x.T, x)`` (for bf16 X with
    ``out_dtype=torch.float32``), each by ``time_ms`` (CUDA events around
    20 eager calls); returns one row per case. Each case is first checked
    against ``plain``. The bound counts N * D * (D + 1) operations for
    the distinct half of the symmetric product and D^2 for adding acc, at
    the peak rate of X's type (fp32 on the FMA pipes; bf16 on the tensor
    cores, whose products of two bf16 values are exact in their fp32
    accumulators), against X read and acc and out moved once."""
    dtype = dtype or torch.float32
    name = str(dtype).replace("torch.", "")
    library = ({} if dtype == torch.float32
               else {"out_dtype": torch.float32})
    rows = []
    for n, d in cases:
        x = torch.randn((n, d), device="cuda", generator=g).to(dtype)
        acc = torch.randn((d, d), device="cuda", generator=g)
        err, ok, _ = hessian_close(kernel(x, acc), plain(x, acc), n)
        check(ok, f"hessian_accum disagrees at N={n} D={d} {name}")
        row = {"shape": [n, d], "dtype": name, "max_abs_err": err,
               "ms": time_ms(lambda: kernel(x, acc)),
               "plain_ms": time_ms(lambda: plain(x, acc)),
               "library_ms": time_ms(
                   lambda: torch.addmm(acc, x.T, x, **library))}
        flop = float(n) * d * (d + 1) + d * d
        row["bound_ms"], row["bound_by"] = bound_ms(
            x.element_size() * n * d + 4.0 * 2 * d * d, flop,
            PEAK_FP32 if dtype == torch.float32 else PEAK_BF16)
        row["tflops"] = flop / row["ms"] / 1e9
        rows.append(row)
        print(f"hessian_accum N={n} D={d} {name}+acc: kernel {row['ms']:.4f} "
              f"ms, plain {row['plain_ms']:.4f} ms, torch.addmm "
              f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}), {flop / 1e9:.2f} GFLOP needed, "
              f"{row['tflops']:.1f} TFLOP/s, "
              f"{row['ms'] / row['library_ms']:.3f}x torch.addmm")
        del x, acc
    return rows


def check_kernels(torch, kernels):
    """Phase 2: each kernel against its plain version; returns per-kernel
    records (without launches) for the JSON line."""
    from repro_torch.kernels import hessian_accum_plain, obs_downdate_plain
    from repro_torch.kernels.hessian_accum import last_wave_fill, launch_plan
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    records = {}

    # --- hessian_accum: every case of HESSIAN_CASES against the plain
    # version, two calls bit for bit, then timed at HESSIAN_TIMED; the
    # JSON line's numbers are the first timed shape's
    for n, d, dt_name, with_acc, offset in HESSIAN_CASES:
        dt = getattr(torch, dt_name)
        x = torch.randn((n, d), device=dev, generator=g).to(dt)
        if offset:  # a view 4 bytes past a 16-byte boundary
            buf = torch.empty(n * d + 1, device=dev, dtype=dt)
            buf[1:].copy_(x.reshape(-1))
            x = buf[1:].view(n, d)
        acc = torch.randn((d, d), device=dev, generator=g) if with_acc else None
        got = kernels.hessian_accum(x, acc)
        torch.cuda.synchronize()
        err, ok, atol = hessian_close(got, hessian_accum_plain(x, acc), n)
        print(f"hessian_accum N={n} D={d} {dt_name} acc={with_acc} "
              f"offset={offset}: max_abs_err={err:.3e} (atol {atol:.2e} + "
              f"rtol 0.0001*|plain|) {'ok' if ok else 'MISMATCH'}")
        check(ok, f"hessian_accum disagrees at N={n} D={d} {dt} "
              f"offset={offset}")
    for n, d in HESSIAN_BITWISE:
        x = torch.randn((n, d), device=dev, generator=g)
        acc = torch.randn((d, d), device=dev, generator=g)
        same = torch.equal(kernels.hessian_accum(x, acc),
                           kernels.hessian_accum(x, acc))
        print(f"hessian_accum N={n} D={d}: two calls "
              f"{'bit-identical' if same else 'DIFFER'}")
        check(same, f"hessian_accum is not deterministic at N={n} D={d}")
    for n, d in HESSIAN_MASKED:
        x = torch.randn((n, d), device=dev, generator=g)
        valid = torch.rand((n,), device=dev, generator=g) > 0.3
        acc = torch.randn((d, d), device=dev, generator=g)
        masked = (x * valid[:, None].float()).contiguous()
        got = kernels.hessian_accum(masked, acc)
        torch.cuda.synchronize()
        err, ok, atol = hessian_close(got, hessian_accum_plain(masked, acc), n)
        rows_err, rows_ok, _ = hessian_close(
            got, hessian_accum_plain(x[valid].contiguous(), acc), n)
        print(f"hessian_accum N={n} D={d} fp32 acc, {int(valid.sum())} rows "
              f"valid, the rest zeroed: max_abs_err={err:.3e} (atol "
              f"{atol:.2e} + rtol 0.0001*|plain|) {'ok' if ok else 'MISMATCH'}"
              f"; against the valid rows alone {rows_err:.3e} "
              f"{'ok' if rows_ok else 'MISMATCH'}")
        check(ok and rows_ok, f"hessian_accum disagrees at N={n} D={d} "
              "with masked rows")
        del x, valid, acc, masked, got
    for n, d in HESSIAN_TIMED:
        entry, bps, plan = launch_plan(torch.empty((n, d), device=dev))
        slots = torch.cuda.get_device_properties(
            dev).multi_processor_count * bps
        print(f"hessian_accum plan N={n} D={d}: {entry}, {bps} blocks an SM, "
              f"{len(plan.upper)} upper tiles x {plan.splits} splits of "
              f"{plan.chunk} rows = {plan.items} items in "
              f"{-(-plan.items // slots)} waves of {slots} (last "
              f"{last_wave_fill(plan.items, slots):.3f} full)")
    rows = time_hessian(torch, kernels.hessian_accum, hessian_accum_plain, g,
                        HESSIAN_TIMED)
    rows += time_hessian(torch, kernels.hessian_accum, hessian_accum_plain, g,
                         HESSIAN_TIMED_BF16, dtype=torch.bfloat16)
    records["hessian_accum"] = {
        "name": "hessian_accum", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/hessian_accum.cu",
        "replaces": "src/repro/kernels/hessian_accum.py:57",
        **{key: rows[0][key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")},
        "other_shapes": [{key: r[key] for key in (
            "shape", "dtype", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")} for r in rows[1:]]}

    # --- obs_downdate: the FFN group (M=12, d_in=d_ff, gs=1) and the
    # attention group (d_in=d_model, gs=head_dim) of GPT-2 small, a d_live
    # prefix, a ragged case, a Phi-3.5-MoE layer's 16 experts,
    # Whisper-large-v3's FFN stack of phase 14 (4 decoder layers, d_ff
    # 5120, d_model 1280) and Llama-3.2-Vision's two stacks of phase 15 (5
    # self layers: the FFN at d_ff 14336, gs 1; the attention's 8 KV groups
    # of 4 x 128 wo_in rows, gs 512)
    main, other = None, []
    for M, d_in, d_out, gs, d_live in [(12, 3072, 768, 1, None),
                                       (12, 768, 768, 64, None),
                                       (12, 3072, 768, 1, 2048),
                                       (3, 130, 12, 5, 96),
                                       (16, 6400, 4096, 1, None),
                                       (4, 5120, 1280, 1, None),
                                       (5, 14336, 4096, 1, None),
                                       (5, 4096, 4096, 512, None)]:
        W = torch.randn((M, d_in, d_out), device=dev, generator=g)
        H = torch.randn((M, d_in, d_in), device=dev, generator=g)
        A = torch.randn((M, d_in, gs), device=dev, generator=g)
        KW = torch.randn((M, gs, d_out), device=dev, generator=g)
        KH = torch.randn((M, gs, d_in), device=dev, generator=g)
        keep = (torch.rand((M, d_in), device=dev, generator=g) > 0.3).float()
        want = obs_downdate_plain(W, H, A, KW, KH, keep, d_live)
        got = kernels.obs_downdate(W.clone(), H.clone(), A, KW, KH, keep,
                                   d_live)
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        ok = all(bool(torch.allclose(a, b, atol=1e-5, rtol=1e-5))
                 for a, b in zip(got, want))
        print(f"obs_downdate M={M} d_in={d_in} d_out={d_out} gs={gs} "
              f"d_live={d_live}: max_abs_err={err:.3e} (atol 1e-5 + rtol "
              f"1e-5*|plain|) {'ok' if ok else 'MISMATCH'}")
        check(ok, f"obs_downdate disagrees at M={M} d_in={d_in} gs={gs} "
              f"d_live={d_live}")
        del want, got
        args = (W, H, A, KW, KH, keep, err)
        if main is None:
            main = args
        elif (M, d_in, d_out, gs) in DOWNDATE_TIMED:
            row = time_downdate(torch, kernels.obs_downdate,
                                obs_downdate_plain, *args)
            other.append({"shape": [M, d_in, d_out, gs], **{
                key: row[key] for key in TIMED_KEYS}})
        del W, H, A, KW, KH, keep, args
    row = time_downdate(torch, kernels.obs_downdate, obs_downdate_plain,
                        *main)
    records["obs_downdate"] = {
        "name": "obs_downdate", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/obs_downdate.cu",
        "replaces": "src/repro/kernels/obs_downdate.py:42",
        **{key: row[key] for key in TIMED_KEYS}, "other_shapes": other}
    del main
    records["flash_attention"] = check_flash(torch, kernels, g)
    records["ssd_intra_chunk"] = check_ssd(torch, kernels, g)
    records["ssd_intra_chunk_backward"] = check_ssd_backward(torch, kernels,
                                                             g)
    return records


# timed beside the main path's shape, (M, d_in, d_out, gs): a Phi-3.5-MoE
# layer's 16 experts, the stack of every step of phase 7's database,
# Whisper-large-v3's 4 decoder FFNs, the stack of phase 14's FFN steps, and
# Llama-3.2-Vision's 5 FFNs and 5 attention modules, phase 15's stacks
DOWNDATE_TIMED = [(16, 6400, 4096, 1), (4, 5120, 1280, 1),
                  (5, 14336, 4096, 1), (5, 4096, 4096, 512)]
TIMED_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
              "library_ms")


def time_downdate(torch, kernel, plain, W, H, A, KW, KH, keep, err,
                  d_live=None):
    """Time ``kernel`` (obs_downdate, in place on copies of W and H)
    beside ``plain`` by ``time_ms``; the bound counts each element of W
    and Hinv written once and each of their live prefix (all of it
    without ``d_live``) read once, the factors and keep read once,
    against a multiply-subtract and two mask multiplies for each live
    element on the fp32 pipes. No single PyTorch call computes the
    function."""
    M, d_in, d_out = W.shape
    gs = A.shape[-1]
    live = d_in if d_live is None else d_live
    Wc, Hc = W.clone(), H.clone()
    row = {"max_abs_err": err, "library_ms": None,
           "ms": time_ms(lambda: kernel(Wc, Hc, A, KW, KH, keep, d_live)),
           "plain_ms": time_ms(lambda: plain(W, H, A, KW, KH, keep,
                                             d_live))}
    nbytes = 4.0 * M * (live * (live + d_out) + d_in * (d_in + d_out)
                        + live * gs + gs * (live + d_out) + live)
    ops = M * live * (live + d_out) * (2.0 * gs + 2.0)
    row["bound_ms"], row["bound_by"] = bound_ms(nbytes, ops, PEAK_FP32)
    print(f"obs_downdate M={M} d_in={d_in} d_out={d_out} gs={gs}"
          f"{'' if d_live is None else f' d_live={d_live}'}: kernel "
          f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']}), "
          f"{nbytes / row['ms'] / 1e6:.0f} GB/s, "
          f"{row['bound_ms'] / row['ms']:.3f} of the bound")
    del Wc, Hc
    return row


# b, sq, sk, hq, hkv, d, causal, window, q_offset (None: sk - sq): the
# reference's FLASH_CASES (tests/test_kernels.py), then GPT-2 small's
# serving prefills (every bucket, 8-1024 tokens, and 8 prompts of 1024),
# GQA with a window and queries inside the keys, and the cases a tiled
# rewrite is likeliest to break: rows without keys (causal, Sq > Sk), a
# first visited key tile wholly masked for later rows, one query
FLASH_CASES = [(2, 128, 128, 4, 4, 64, True, 0, None),
               (1, 256, 256, 8, 2, 64, True, 0, None),
               (2, 128, 128, 4, 1, 128, True, 64, None),
               (1, 96, 224, 2, 2, 64, True, 0, None),
               (1, 128, 128, 4, 4, 64, False, 0, None),
               (2, 130, 130, 2, 2, 32, True, 0, None)]
FLASH_SERVING = [(1, s, s, 12, 12, 64, True, 0, None)
                 for s in (8, 16, 32, 64, 128, 256, 512, 1024)]
FLASH_BATCHED = (8, 1024, 1024, 12, 12, 64, True, 0, None)
FLASH_GQA = (2, 100, 300, 8, 2, 64, True, 96, 150)
FLASH_EDGE = [(2, 200, 130, 4, 2, 16, True, 0, None),
              (2, 128, 500, 4, 2, 64, True, 20, 300),
              (2, 1, 300, 8, 2, 64, True, 0, 299)]
# Phi-3.5-MoE's prefills in phase 7: GQA 32:8 at head dim 128, the
# engine's buckets for prompts of 128-512 tokens
FLASH_MOE = [(1, s, s, 32, 8, 128, True, 0, None) for s in (128, 256, 512)]
# Hymba-1.5B's attention (phase 13): 25 query heads on 5 KV heads of 64,
# a 1024-token window, 4096 tokens whole, then the two query chunks of
# 2048 that models.attention.flash_attention_chunked launches for them
# (the second against keys 1024-4095, its queries at offset 1024)
FLASH_HYMBA = (1, 4096, 4096, 25, 5, 64, True, 1024, None)
FLASH_HYMBA_CHUNKS = [(1, 2048, 2048, 25, 5, 64, True, 1024, 0),
                      (1, 2048, 3072, 25, 5, 64, True, 1024, 1024)]
# timed in bf16 causal beside scaled_dot_product_attention: buckets 128,
# 256 and 512, the batched shape, and last the JSON line's shape
FLASH_TIMED = [FLASH_SERVING[4], FLASH_SERVING[5], FLASH_SERVING[6],
               FLASH_BATCHED, FLASH_SERVING[7]]
# timed apart, under the JSON line's ``other_shapes``: Hymba's windowed
# shape, and the same shape causal without the window (do the key tiles
# wholly outside the window cost nothing?)
FLASH_TIMED_HYMBA = [FLASH_HYMBA, FLASH_HYMBA[:7] + (0, None)]


def attended_pairs(sq, sk, causal, window, q_offset):
    """(query, key) pairs the masks keep: the work the function needs."""
    import numpy as np
    qpos = q_offset + np.arange(sq)[:, None]
    kpos = np.arange(sk)[None, :]
    keep = np.ones((sq, sk), bool)
    if causal:
        keep &= kpos <= qpos
    if window:
        keep &= kpos > qpos - window
    return int(keep.sum())


def check_flash(torch, kernels, g):
    """Phase 2, flash attention: the reference's cases in fp32 (tolerance
    2e-5) and bf16 (2e-2), the serving shapes, a GQA + window + q_offset
    case and the edge cases in bf16; timed in bf16 causal at GPT-2 small's
    prefill buckets 128-1024 and at 8 prompts of 1024, beside
    ``scaled_dot_product_attention`` and the bound."""
    from repro_torch.kernels import flash_attention_plain
    dev = torch.device("cuda")
    cases = ([(c, torch.float32) for c in FLASH_CASES]
             + [(c, torch.bfloat16) for c in FLASH_CASES + FLASH_SERVING
                + [FLASH_BATCHED, FLASH_GQA] + FLASH_EDGE + FLASH_MOE
                + [FLASH_HYMBA] + FLASH_HYMBA_CHUNKS])
    for case, dt in cases:
        b, sq, sk, hq, hkv, d, causal, window, q_off = case
        q, k, v = (torch.randn(shape, device=dev, generator=g).to(dt)
                   for shape in ((b, sq, hq, d), (b, sk, hkv, d),
                                 (b, sk, hkv, d)))
        kw = {"causal": causal, "window": window, "q_offset": q_off}
        got = kernels.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        want = flash_attention_plain(q, k, v, **kw)
        tol = 2e-5 if dt == torch.float32 else 2e-2
        err = float((got.float() - want.float()).abs().max())
        ok = bool(torch.allclose(got.float(), want.float(), atol=tol,
                                 rtol=tol))
        print(f"flash_attention {case} {str(dt)[6:]}: max_abs_err={err:.3e} "
              f"(atol {tol:g} + rtol {tol:g}*|plain|) "
              f"{'ok' if ok else 'MISMATCH'}")
        check(ok, f"flash_attention disagrees at {case} {dt}")
        del got, want
    # the JSON line's shape is the last timed one, the longest serving
    # prefill; Hymba's windowed shape and its causal twin beside it
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "device_ms", "library_device_ms")
    row = time_flash(torch, kernels.flash_attention, flash_attention_plain,
                     g, FLASH_TIMED)[-1]
    other = time_flash(torch, kernels.flash_attention, flash_attention_plain,
                       g, FLASH_TIMED_HYMBA)
    win, full = other
    print(f"flash_attention {tuple(FLASH_HYMBA[:6])} bf16: the 1024-token "
          f"window keeps {win['pairs'] / full['pairs']:.4f} of the causal "
          f"pairs and takes {win['device_ms'] / full['device_ms']:.4f} of "
          f"the causal device time")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:76",
            **{key: row[key] for key in keys},
            "other_shapes": [{"shape": r["shape"], **{key: r[key]
                                                      for key in keys}}
                             for r in other]}


def time_flash(torch, flash, plain, g, cases):
    """Time ``flash`` in bf16 at each of ``cases`` (their masks: causal,
    the window and the queries' offset) beside ``plain`` (its plain
    version) and ``scaled_dot_product_attention`` (``is_causal`` for a
    square causal case without a window, else the case's boolean mask;
    ``enable_gqa`` for grouped heads); returns one row per case, its
    ``shape`` the case's (b, sq, sk, hq, hkv, d) and then its window
    where it has one. Each case is first checked against ``plain`` at
    2e-2.
    ``ms``, ``plain_ms`` and ``library_ms`` are ``time_ms`` (CUDA events
    around 20 eager calls, the host's launch path included: the yardstick
    of every kernel in the JSON line); ``device_ms`` and
    ``library_device_ms`` are ``graph_ms`` (the same calls replayed from a
    CUDA graph: the device's time alone, which for a kernel of tens of
    microseconds is less than its wrapper's host path)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for b, sq, sk, hq, hkv, d, causal, window, q_off in cases:
        q, k, v = (torch.randn(shape, device="cuda", generator=g).bfloat16()
                   for shape in ((b, sq, hq, d), (b, sk, hkv, d),
                                 (b, sk, hkv, d)))
        q_off = sk - sq if q_off is None else q_off
        kw = {"causal": causal, "window": window, "q_offset": q_off}
        got, want = flash(q, k, v, **kw), plain(q, k, v, **kw)
        err = float((got.float() - want.float()).abs().max())
        check(bool(torch.allclose(got.float(), want.float(), atol=2e-2,
                                  rtol=2e-2)),
              f"flash_attention disagrees at {(b, sq, sk, hq, hkv, d)}")
        del got, want
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib = {"enable_gqa": True} if hq != hkv else {}
        if causal and not window and sq == sk:
            lib["is_causal"] = True
        else:
            qpos = q_off + torch.arange(sq, device="cuda")[:, None]
            kpos = torch.arange(sk, device="cuda")[None, :]
            keep = torch.ones((sq, sk), dtype=torch.bool, device="cuda")
            if causal:
                keep &= kpos <= qpos
            if window:
                keep &= kpos > qpos - window
            lib["attn_mask"] = keep
        calls = {"": lambda: flash(q, k, v, **kw),
                 "library_": lambda: sdpa(qt, kt, vt, **lib)}
        pairs = attended_pairs(sq, sk, causal, window, q_off)
        row = {"shape": [b, sq, sk, hq, hkv, d] + ([window] if window
                                                     else []),
               "max_abs_err": err, "pairs": pairs}
        for pre, fn in calls.items():
            row[pre + "ms"] = time_ms(fn)
            row[pre + "device_ms"] = graph_ms(fn)
        row["plain_ms"] = time_ms(lambda: plain(q, k, v, **kw))
        ops = 4.0 * b * hq * d * pairs
        nbytes = 2.0 * (2 * q.numel() + k.numel() + v.numel())
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, ops, PEAK_BF16)
        row["device_tflops"] = ops / row["device_ms"] / 1e9
        rows.append(row)
        masks = ("causal" if causal else "full") + (
            f", window {window}" if window else "")
        print(f"flash_attention {(b, sq, sk, hq, hkv, d)} bf16 {masks}: "
              f"kernel {row['ms']:.4f} ms eager, {row['device_ms']:.4f} ms "
              f"device (graph); scaled_dot_product_attention "
              f"{row['library_ms']:.4f} ms eager, "
              f"{row['library_device_ms']:.4f} ms device"
              f"{'' if 'is_causal' in lib else ' (with the boolean mask)'}"
              f"; plain "
              f"{row['plain_ms']:.4f} ms eager; bound {row['bound_ms']:.4f} "
              f"ms ({row['bound_by']}; {ops / 1e9:.3f} GFLOP over "
              f"{PEAK_BF16 / 1e12:.0f} TFLOP/s, {nbytes / 1e6:.2f} MB over "
              f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s); "
              f"{row['device_tflops']:.1f} TFLOP/s on the device, "
              f"{row['device_ms'] / row['library_device_ms']:.2f}x SDPA's "
              f"device time")
    return rows


# b, s, h, p, n, chunk: the reference's SSD_CASES (tests/test_kernels.py;
# s = 50 with chunk 16 is ragged), then Mamba-2 2.7B's calibration batch
# (8 x 512 tokens, so (b, nc, q) = (8, 4, 128): the timed shape), a chunk
# of 256 and a ragged length at the full width
SSD_CASES = [(2, 64, 4, 32, 16, 32), (1, 96, 8, 16, 8, 32),
             (2, 50, 2, 64, 32, 16), (1, 128, 6, 32, 16, 64)]
SSD_MAIN = (8, 512, 80, 64, 128, 128)
SSD_WIDE = [(1, 512, 80, 64, 128, 256), (2, 300, 80, 64, 128, 128)]
# Hymba-1.5B's SSD heads on its calibration batch (phase 13; a train step
# on 8 x 512 tokens gives the backward the same shape): 25 heads of 64,
# state 16, chunks of 256 (four query tiles of 64), so (b, nc, q) = (8, 2,
# 256); timed apart from SSD_TIMED, under the JSON line's
# ``other_shapes``
SSD_HYMBA = (8, 512, 25, 64, 16, 256)
# timed with bf16 B and C: the calibration batch, then half and a fifth of
# its heads, as stand-ins for the search's pruned candidates
SSD_TIMED = [SSD_MAIN, (8, 512, 40, 64, 128, 128), (8, 512, 16, 64, 128, 128)]
# kernel vs plain, by the type of B and C: in fp32, sums of up to a chunk
# of terms in another order (atol = rtol = 1e-4); with bf16 B and C the
# plain version rounds the scores to bf16 as the reference's model twin
# does and the kernel keeps them fp32, a relative 2^-9 per score summed
# over up to a chunk of terms (2e-2 of the output's largest magnitude)
SSD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def ssd_close(torch, got, want, bc):
    """(max abs error over both outputs, ok) of the SSD outputs (y_diag,
    states) under SSD_TOL[bc]; with bf16 B and C each output's error is
    held to SSD_TOL of its own largest magnitude, as
    tests/test_torch_cuda.py holds it."""
    tol, err, ok = SSD_TOL[bc], 0.0, True
    for a, b in zip(got, want):
        e = float((a - b).abs().max())
        err = max(err, e)
        if bc == "float32":
            ok = ok and bool(torch.allclose(a, b, atol=tol, rtol=tol))
        else:
            ok = ok and e <= tol * float(b.abs().max())
    return err, ok
# the chunked scan against the recurrence: the reference's SSD tolerance
SSD_SCAN_TOL = 2e-3


def ssd_data(torch, case, dtype, g):
    """x, dt (softplus'ed), A, B, C on the card; x, B, C in ``dtype``."""
    b, s, h, p, n, _ = case
    dev = torch.device("cuda")
    x = torch.randn((b, s, h, p), device=dev, generator=g) * 0.5
    dt = torch.nn.functional.softplus(
        torch.randn((b, s, h), device=dev, generator=g))
    A = -torch.exp(torch.randn((h,), device=dev, generator=g) * 0.3)
    B, C = (torch.randn((b, s, n), device=dev, generator=g) * 0.5
            for _ in range(2))
    return x.to(dtype), dt, A, B.to(dtype), C.to(dtype)


def ssd_recurrence(torch, x, dt, A, B, C, initial_state=None):
    """Token-by-token SSD recurrence, the reference's ``ref.ssd_ref``."""
    b, s, h, p = x.shape
    state = (initial_state if initial_state is not None else
             torch.zeros((b, h, p, B.shape[-1]), device=x.device))
    ys = []
    for t in range(s):
        decay = torch.exp(dt[:, t] * A)
        state = state * decay[..., None, None] + torch.einsum(
            "bh,bn,bhp->bhpn", dt[:, t], B[:, t].float(), x[:, t].float())
        ys.append(torch.einsum("bn,bhpn->bhp", C[:, t].float(), state))
    return torch.stack(ys, 1).to(x.dtype), state


def check_ssd(torch, kernels, g):
    """Phase 2, the SSD intra-chunk pass: the reference's cases in fp32,
    the full-width shapes with x, B and C made in bf16 (xdt formed as the
    model forms it) and B, C handed over in fp32 and in bf16; then the
    whole chunked scan against the recurrence, with and without an
    initial state; two calls bit for bit; the launch plan and
    ``time_ssd`` at SSD_TIMED (the calibration batch as the main path runs
    it, bf16 B and C, then 40 and 16 heads) and at Hymba's SSD_HYMBA. The
    JSON line's numbers are the calibration batch's, the other shapes
    under ``other_shapes``."""
    from repro_torch.kernels import ssd_intra_chunk_plain
    from repro_torch.kernels.ssd_scan import (intra_chunk_inputs, launch_plan,
                                              ssd_chunked, waves)
    cases = ([(c, "float32", "float32") for c in SSD_CASES]
             + [(c, "bfloat16", bc) for c in [SSD_MAIN] + SSD_WIDE
                + [SSD_HYMBA] for bc in ("float32", "bfloat16")])
    for case, in_dt, bc in cases:
        x, dt, A, B, C = ssd_data(torch, case, getattr(torch, in_dt), g)
        xdt, dacs, Bb, Cb = intra_chunk_inputs(x, dt, A, B, C, case[-1])
        Bb, Cb = Bb.to(getattr(torch, bc)), Cb.to(getattr(torch, bc))
        got = kernels.ssd_intra_chunk(xdt, dacs, Bb, Cb)
        torch.cuda.synchronize()
        want = ssd_intra_chunk_plain(xdt, dacs, Bb, Cb)
        err, ok = ssd_close(torch, got, want, bc)
        tol = (f"atol {SSD_TOL[bc]:g} + rtol {SSD_TOL[bc]:g}*|plain|"
               if bc == "float32" else f"{SSD_TOL[bc]:g}*max|plain| each")
        line = (f"ssd_intra_chunk (b, s, h, p, n, chunk)={case} x {in_dt}, "
                f"B/C {bc}: (b, nc, q)={tuple(xdt.shape[:3])} max_abs_err="
                f"{err:.3e} ({tol}) {'ok' if ok else 'MISMATCH'}")
        if bc == "bfloat16":
            # the kernel's bf16 scores are exact products: against the
            # plain version on B and C in fp32 it holds the fp32 tolerance
            err32, ok32 = ssd_close(torch, got, ssd_intra_chunk_plain(
                xdt, dacs, Bb.float(), Cb.float()), "float32")
            line += (f"; against the plain version on fp32 B/C "
                     f"{err32:.3e} (atol {SSD_TOL['float32']:g} + rtol "
                     f"{SSD_TOL['float32']:g}*|plain|) "
                     f"{'ok' if ok32 else 'MISMATCH'}")
            ok = ok and ok32
        print(line)
        check(ok, f"ssd_intra_chunk disagrees at {case} B/C {bc}")
        del x, dt, B, C, xdt, dacs, Bb, Cb, got, want

    for case in (SSD_CASES[2], (1, 300, 8, 64, 128, 128)):
        b, s, h, p, n, chunk = case
        x, dt, A, B, C = ssd_data(torch, case, torch.float32, g)
        init = torch.randn((b, h, p, n), device="cuda", generator=g) * 0.1
        for state in (None, init):
            y, st = ssd_chunked(x, dt, A, B, C, chunk, initial_state=state)
            y_w, st_w = ssd_recurrence(torch, x, dt, A, B, C, state)
            err = max(float((y - y_w).abs().max()),
                      float((st - st_w).abs().max()))
            ok = bool(torch.allclose(y, y_w, atol=SSD_SCAN_TOL,
                                     rtol=SSD_SCAN_TOL)) and bool(
                torch.allclose(st, st_w, atol=SSD_SCAN_TOL,
                               rtol=SSD_SCAN_TOL))
            print(f"ssd_chunked {case} initial_state="
                  f"{'given' if state is not None else 'none'} vs the "
                  f"recurrence: max_abs_err={err:.3e} (tol {SSD_SCAN_TOL:g})"
                  f" {'ok' if ok else 'MISMATCH'}")
            check(ok, f"ssd_chunked disagrees with the recurrence at {case}")

    # two calls bit for bit: the calibration shape and chunks of 256
    for case in (SSD_MAIN, SSD_WIDE[0], SSD_HYMBA):
        x, dt, A, B, C = ssd_data(torch, case, torch.bfloat16, g)
        inputs = intra_chunk_inputs(x, dt, A, B, C, case[-1])
        same = all(torch.equal(a, b) for a, b in zip(
            kernels.ssd_intra_chunk(*inputs), kernels.ssd_intra_chunk(*inputs)))
        print(f"ssd_intra_chunk {case}: two calls "
              f"{'bit-identical' if same else 'DIFFER'}")
        check(same, f"ssd_intra_chunk is not deterministic at {case}")
        del x, dt, B, C, inputs
    for b, s, h, p, n, chunk in SSD_TIMED + [SSD_HYMBA]:
        plan = launch_plan(torch.empty((b, s // chunk, chunk, h, p),
                                       device="cuda"),
                           torch.empty(0, device="cuda", dtype=torch.bfloat16))
        slots = plan.sms * plan.blocks_per_sm
        print(f"ssd_intra_chunk plan (b, s, h, p, n, chunk)="
              f"{(b, s, h, p, n, chunk)}: query tile {plan.layout.qt} rows x "
              f"{plan.layout.tiles}, {plan.groups} head groups, {plan.blocks} "
              f"blocks, {plan.layout.smem} B of shared memory, "
              f"{plan.blocks_per_sm} block(s) an SM, "
              f"{waves(plan.blocks, slots)} wave(s) of {slots}")
    rows = time_ssd(torch, kernels.ssd_intra_chunk, ssd_intra_chunk_plain, g,
                    SSD_TIMED + [SSD_HYMBA])
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "device_ms")
    return {"name": "ssd_intra_chunk", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:52",
            **{key: rows[0][key] for key in keys},
            "other_shapes": [{"shape": r["shape"], **{key: r[key]
                                                      for key in keys}}
                             for r in rows[1:]]}


def time_ssd(torch, kernel, plain, g, cases):
    """Time ``kernel`` (the intra-chunk pass) at each (b, s, h, p, n,
    chunk) of ``cases`` with x, B and C made in bf16 and xdt formed as the
    model forms it (so B and C reach the kernel in bf16), beside ``plain``
    (its plain version); returns one row per case. Each case is first
    checked against ``plain`` under SSD_TOL["bfloat16"]. ``ms`` and
    ``plain_ms`` are ``time_ms`` (CUDA events around 20 eager calls, the
    yardstick of every kernel in the JSON line), ``device_ms`` is
    ``graph_ms`` (the same calls replayed from a CUDA graph). No single
    PyTorch call computes the function (``library_ms`` None). The bound
    counts the causal scores Q(Q+1)/2 x N, y_diag Q(Q+1)/2 x H x P and the
    states Q x H x P x N multiply-adds per chunk at the tensor cores' TF32
    rate, against each input read and each output written once; the old
    reckoning at the CUDA cores' fp32 rate is printed beside it."""
    from repro_torch.kernels.ssd_scan import intra_chunk_inputs
    rows = []
    for case in cases:
        x, dt, A, B, C = ssd_data(torch, case, torch.bfloat16, g)
        xdt, dacs, Bb, Cb = intra_chunk_inputs(x, dt, A, B, C, case[-1])
        del x, dt, B, C
        b, nc, q, h, p = xdt.shape
        n = Bb.shape[-1]
        err, ok = ssd_close(torch, kernel(xdt, dacs, Bb, Cb),
                            plain(xdt, dacs, Bb, Cb), "bfloat16")
        check(ok, f"ssd_intra_chunk disagrees at {case} (timed)")
        row = {"shape": [b, nc, q, h, p, n], "max_abs_err": err,
               "ms": time_ms(lambda: kernel(xdt, dacs, Bb, Cb)),
               "device_ms": graph_ms(lambda: kernel(xdt, dacs, Bb, Cb)),
               "plain_ms": time_ms(lambda: plain(xdt, dacs, Bb, Cb)),
               "library_ms": None}
        tri = q * (q + 1) / 2
        ops = 2.0 * b * nc * (tri * n + tri * h * p + q * h * p * n)
        nbytes = (4.0 * (xdt.numel() + dacs.numel())
                  + Bb.element_size() * (Bb.numel() + Cb.numel())
                  + 4.0 * (xdt.numel() + b * nc * h * p * n))
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, ops, PEAK_TF32)
        fp32_bound, _ = bound_ms(nbytes, ops, PEAK_FP32)
        rows.append(row)
        print(f"ssd_intra_chunk (b, nc, q, h, p, n)={(b, nc, q, h, p, n)} "
              f"B/C bf16: kernel {row['ms']:.4f} ms eager, "
              f"{row['device_ms']:.4f} ms device (graph); plain "
              f"{row['plain_ms']:.4f} ms eager; no single PyTorch call; "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}; "
              f"{ops / 1e9:.3f} GFLOP over {PEAK_TF32 / 1e12:.0f} TFLOP/s "
              f"TF32, {nbytes / 1e6:.2f} MB over "
              f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s; {fp32_bound:.4f} ms at "
              f"the CUDA cores' {PEAK_FP32 / 1e12:.0f} TFLOP/s); "
              f"{row['bound_ms'] / row['ms']:.3f} of the bound eager, "
              f"{row['bound_ms'] / row['device_ms']:.3f} on the device")
        del xdt, dacs, Bb, Cb
    return rows


def ssd_backward_close(torch, got, want, bc):
    """(max abs error over the four gradients, ok): each of dxdt, ddacs,
    dB and dC within SSD_TOL[bc] of its own largest magnitude (with bf16 B
    and C both sides form the scores in fp32 and round dB and dC to bf16
    once; they differ by the sums' order and that rounding)."""
    tol, err, ok = SSD_TOL[bc], 0.0, True
    for a, b in zip(got, want):
        e = float((a.float() - b.float()).abs().max())
        err = max(err, e)
        ok = ok and a.dtype == b.dtype and e <= tol * float(
            b.float().abs().max())
    return err, ok


def ssd_backward_inputs(torch, case, in_dt, bc, g):
    """The backward's inputs at ``case``: the forward's (as check_ssd forms
    them, B and C in ``bc``) and fp32 cotangents dy, dstates."""
    from repro_torch.kernels.ssd_scan import intra_chunk_inputs
    x, dt, A, B, C = ssd_data(torch, case, getattr(torch, in_dt), g)
    xdt, dacs, Bb, Cb = intra_chunk_inputs(x, dt, A, B, C, case[-1])
    b, nc, q, h, p = xdt.shape
    dy = torch.randn(xdt.shape, device="cuda", generator=g)
    dst = torch.randn((b, nc, h, p, Bb.shape[-1]), device="cuda",
                      generator=g)
    return (xdt, dacs, Bb.to(getattr(torch, bc)), Cb.to(getattr(torch, bc)),
            dy, dst)


def check_ssd_backward(torch, kernels, g):
    """Phase 2, the SSD backward kernel against
    ``ssd_intra_chunk_backward_plain`` at the forward's check cases (the
    reference's in fp32; the calibration and training shape (8, 4, 128,
    80, 64, 128), the wide ones and Hymba's (8, 2, 256, 25, 64, 16) with B
    and C in fp32 and in bf16): each gradient within SSD_TOL of its own
    scale; two calls bit for bit at the training shape and at chunks of
    256; then ``time_ssd_backward`` at the training shape with bf16 B and
    C, as a train step of Mamba-2 2.7B gives them, and at Hymba's (under
    ``other_shapes``)."""
    from repro_torch.kernels import ssd_intra_chunk_backward_plain
    cases = ([(c, "float32", "float32") for c in SSD_CASES]
             + [(c, "bfloat16", bc) for c in [SSD_MAIN] + SSD_WIDE
                + [SSD_HYMBA] for bc in ("float32", "bfloat16")])
    for case, in_dt, bc in cases:
        args = ssd_backward_inputs(torch, case, in_dt, bc, g)
        got = kernels.ssd_intra_chunk_backward(*args)
        torch.cuda.synchronize()
        err, ok = ssd_backward_close(
            torch, got, ssd_intra_chunk_backward_plain(*args), bc)
        print(f"ssd_intra_chunk_backward (b, s, h, p, n, chunk)={case} x "
              f"{in_dt}, B/C {bc}: (b, nc, q)={tuple(args[0].shape[:3])} "
              f"max_abs_err={err:.3e} ({SSD_TOL[bc]:g}*max|plain| each of "
              f"dxdt, ddacs, dB, dC) {'ok' if ok else 'MISMATCH'}")
        check(ok, f"ssd_intra_chunk_backward disagrees at {case} B/C {bc}")
        del args, got
    for case in (SSD_MAIN, SSD_WIDE[0], SSD_HYMBA):
        args = ssd_backward_inputs(torch, case, "bfloat16", "bfloat16", g)
        same = all(torch.equal(a, b) for a, b in zip(
            kernels.ssd_intra_chunk_backward(*args),
            kernels.ssd_intra_chunk_backward(*args)))
        print(f"ssd_intra_chunk_backward {case}: two calls "
              f"{'bit-identical' if same else 'DIFFER'}")
        check(same, f"ssd_intra_chunk_backward is not deterministic at "
              f"{case}")
        del args
    hymba = time_ssd_backward(torch, kernels.ssd_intra_chunk_backward,
                              ssd_intra_chunk_backward_plain, g, SSD_HYMBA,
                              profile=False)
    return {"name": "ssd_intra_chunk_backward", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:52",
            "note": "the backward of that kernel, which has none on the "
                    "TPU: the reference differentiates "
                    "src/repro/models/ssm.py:93-152",
            **time_ssd_backward(torch, kernels.ssd_intra_chunk_backward,
                                ssd_intra_chunk_backward_plain, g),
            "other_shapes": [{key: hymba[key] for key in (
                "shape", "max_abs_err", "ms", "device_ms", "plain_ms",
                "library_ms", "bound_ms", "bound_by")}]}


def time_ssd_backward(torch, kernel, plain, g, case=SSD_MAIN,
                      profile: bool = True):
    """Time ``kernel`` (the SSD backward) at ``case`` (SSD_MAIN, the
    Mamba-2 train step's shape, unless given) with bf16 B and C, beside
    ``plain`` (its plain version): each
    checked first under SSD_TOL["bfloat16"]; ``ms`` and ``plain_ms`` by
    ``time_ms``, ``device_ms`` by ``graph_ms``. No single PyTorch call
    computes the function. The bound counts G and (S o L)^T dy (Q(Q+1)/2
    x P multiply-adds each a head), W and the states' share of dB (Q x P
    x N each a head), S, dC and dS^T C (Q(Q+1)/2 x N each a chunk) at the
    tensor cores' TF32 rate, as ``time_ssd`` counts the forward's same
    operand types, against each input read and each output written once;
    the split products the kernel executes (3 TF32 products for G, (S o
    L)^T dy and the states' share of dB, 2 for W, dC and dS^T C with bf16
    B and C, 1 bf16 for S) are printed beside it. With ``profile``,
    ``passes_ms`` splits a call's device time by pass."""
    args = ssd_backward_inputs(torch, case, "bfloat16", "bfloat16", g)
    xdt, dacs, Bb, Cb, dy, dst = args
    b, nc, q, h, p = xdt.shape
    n = Bb.shape[-1]
    err, ok = ssd_backward_close(torch, kernel(*args), plain(*args),
                                 "bfloat16")
    check(ok, "ssd_intra_chunk_backward disagrees at the timed shape")
    rec = {"shape": [b, nc, q, h, p, n], "max_abs_err": err,
           "ms": time_ms(lambda: kernel(*args)),
           "device_ms": graph_ms(lambda: kernel(*args)),
           "plain_ms": time_ms(lambda: plain(*args)), "library_ms": None}
    tri = q * (q + 1) / 2
    macs = b * nc * (h * (2 * tri * p + 2 * q * p * n) + 3 * tri * n)
    nbytes = (4.0 * (2 * xdt.numel() + dst.numel() + dacs.numel())
              + 2 * Bb.element_size() * Bb.numel()     # B and C in
              + 4.0 * (xdt.numel() + dacs.numel())     # dxdt, ddacs out
              + 2 * Bb.element_size() * Bb.numel())    # dB and dC out
    rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes, 2.0 * macs,
                                                PEAK_TF32)
    split_flop = 2.0 * b * nc * (h * (3 * 2 * tri * p + 5 * q * p * n)
                                 + 5 * tri * n)
    print(f"ssd_intra_chunk_backward (b, nc, q, h, p, n)="
          f"{(b, nc, q, h, p, n)} B/C bf16: kernel {rec['ms']:.4f} ms "
          f"eager, {rec['device_ms']:.4f} ms device (graph); plain "
          f"{rec['plain_ms']:.4f} ms eager; no single PyTorch call; bound "
          f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}; "
          f"{2 * macs / 1e9:.3f} GFLOP over {PEAK_TF32 / 1e12:.0f} TFLOP/s "
          f"TF32, {nbytes / 1e6:.2f} MB over {HBM_BYTES_PER_S / 1e12:.2f} "
          f"TB/s; the split products execute {split_flop / 1e9:.3f} "
          f"GFLOP of TF32, {split_flop / PEAK_TF32 * 1e3:.4f} ms at the "
          f"peak); "
          f"{rec['bound_ms'] / rec['ms']:.3f} of the bound eager, "
          f"{rec['bound_ms'] / rec['device_ms']:.3f} on the device")
    if profile:
        rec["passes_ms"] = passes_ms(torch, lambda: kernel(*args))
        print("ssd_intra_chunk_backward device ms a call by pass (profiler, "
              f"{PROFILED_CALLS} calls): " + ", ".join(
                  f"{k} {v:.4f}" for k, v in rec["passes_ms"].items()))
    del args, xdt, dacs, Bb, Cb, dy, dst
    return rec


PROFILED_CALLS = 10


def passes_ms(torch, fn):
    """Device milliseconds a call of each kernel ``fn`` launches, by the
    kernel's name (the SSD backward's are named after its passes), from
    ``torch.profiler``'s averages over PROFILED_CALLS calls."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_CALLS):
            fn()
        torch.cuda.synchronize()
    import re
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", 0)
        # "void (anonymous namespace)::dx_pass<__nv_bfloat16, 64>(...)"
        m = re.search(r"\b(\w+_pass|sum_parts)\b", e.key)
        if us and m:
            out[m[1]] = out.get(m[1], 0.0) + us / 1e3 / PROFILED_CALLS
    return out


def compare_databases(np, db_cpu, db_gpu, label):
    """The card's database against the CPU's. The card's inverse and
    reductions round differently from the CPU's, and Algorithm 1 meets
    near-ties late in a run (a 1e-6 relative perturbation of a Hessian
    already swaps two neighbouring removals on the CPU). So: the removed
    sets at each level may differ by a few near-tied structures; where
    they coincide the snapshots agree at fp16 tolerance, and every
    level's error agrees to 1e-3."""
    for name, a in db_cpu.items():
        b = db_gpu[name]
        n = a.mod.n_structures
        same = int(np.argmin(np.append(a.order == b.order, False)))
        worst, checked = 0, 0
        for i, lvl in enumerate(a.levels):
            diff = len(set(a.order[:lvl].tolist())
                       ^ set(b.order[:lvl].tolist())) // 2
            worst = max(worst, diff)
            if diff == 0:
                checked += 1
                np.testing.assert_allclose(
                    b.snapshots[i].astype(np.float32),
                    a.snapshots[i].astype(np.float32), atol=2e-3, rtol=2e-3,
                    err_msg=f"{name} level {lvl}")
        np.testing.assert_allclose(b.errors, a.errors, rtol=1e-3, atol=1e-6,
                                   err_msg=name)
        print(f"{label}: {name} card vs CPU: first {same}/{len(a.order)} "
              f"removals identical, removed sets differ by at most {worst} "
              f"structure(s) at a level, {checked}/{len(a.levels)} levels' "
              f"snapshots within fp16 tolerance, errors within 1e-3")
        check(worst <= max(1, n // 50), f"{name}: removed sets differ")


def check_small_slice(torch):
    """Phase 3: a 2-layer GPT-2 (fp32) run on the card and on the CPU:
    Hessians, database and the stitched members' losses must agree."""
    import numpy as np
    from repro_torch.configs import GPT2_SMALL
    from repro_torch.core.database import apply_assignment, build_database
    from repro_torch.core.hessian import collect_hessians
    from repro_torch.core.oneshot import calib_loss_fn
    from repro_torch.core.spdy import search_family
    from repro_torch.core.latency import build_table
    from repro_torch.data import calibration_batches
    from repro_torch.models import model_init
    from repro_torch.models.transformer import tree_to
    from repro_torch.runtime.costmodel import InferenceEnv

    cfg = GPT2_SMALL.replace(name="gpt2-tiny", num_layers=2, d_model=96,
                             d_ff=384, num_heads=6, num_kv_heads=6,
                             head_dim=16, vocab_size=384, dtype="float32")
    p_cpu = model_init(cfg, torch.Generator().manual_seed(1), device="cpu")
    p_gpu = tree_to(p_cpu, "cuda")
    calib = calibration_batches(cfg, 16, 64, batch=8)
    h_cpu = collect_hessians(cfg, p_cpu, calib, device="cpu")
    h_gpu = collect_hessians(cfg, p_gpu, calib, device="cuda")
    herr = max(float((h_gpu[k].cpu() - h_cpu[k]).abs().max()) for k in h_cpu)
    hscale = max(float(h.abs().max()) for h in h_cpu.values())
    print(f"small slice: Hessians card vs CPU max_abs_err={herr:.3e} "
          f"(scale {hscale:.3e}, tol 1e-4*scale)")
    check(herr <= 1e-4 * hscale, "Hessians disagree between card and CPU")

    db_cpu = build_database(cfg, p_cpu, h_cpu, device="cpu")
    db_gpu = build_database(cfg, p_gpu, h_cpu, device="cuda")
    compare_databases(np, db_cpu, db_gpu, "small slice")

    env = InferenceEnv(batch=4, seq=64, hw=None)
    table = build_table(cfg, env, backend="measure", device="cpu")
    res = search_family(db_cpu, table, [1.5, 2.0], steps=32, seed=0)
    loss_cpu = calib_loss_fn(cfg, calib[:1], device="cpu")
    loss_gpu = calib_loss_fn(cfg, calib[:1], device="cuda")
    for t, r in res.items():
        lc = loss_cpu(apply_assignment(cfg, p_cpu, db_cpu, r.assignment))
        lg = loss_gpu(apply_assignment(cfg, p_gpu, db_gpu, r.assignment))
        # 1e-3: each side stitches its own database (see above)
        print(f"small slice: {t}x member loss card {lg:.6f} CPU {lc:.6f} "
              f"(tol 1e-3 relative)")
        check(abs(lg - lc) <= 1e-3 * abs(lc), f"{t}x member losses differ")
    check_small_train(torch, cfg, p_cpu, db_cpu, res[2.0].assignment)


# to_host's staging at the edges of its chunks: (elements, chunk, dtype)
TO_HOST_CASES = [(n, 1000, dt) for n in (0, 1, 999, 1000, 1001, 2000, 3500)
                 for dt in ("float16", "float32")] + [(3 << 20, 1 << 20,
                                                      "float16")]


def check_to_host(torch):
    """The databases' and checkpoints' device-to-host copy (pinned
    staging, chunk by chunk) against ``.cpu()``, bit for bit."""
    from repro_torch.runtime.device import to_host
    g = torch.Generator(device="cuda").manual_seed(11)
    for n, chunk, dt in TO_HOST_CASES:
        x = torch.randn(n, 3, generator=g, device="cuda").to(
            getattr(torch, dt))
        got = to_host(x, chunk=chunk)
        check(got.shape == (n, 3) and bool(torch.equal(
            torch.from_numpy(got), x.cpu())),
            f"to_host of ({n}, 3) {dt} in chunks of {chunk} differs from "
            ".cpu()")
    print(f"to_host == .cpu() bit for bit at {len(TO_HOST_CASES)} sizes "
          "and chunks")


def rows_zero(torch, params, db, assignment) -> bool:
    """Every removed structure's out-side rows are exactly 0."""
    import numpy as np
    from repro_torch.core.structures import UNITS
    for name, removed in assignment.items():
        mod = db[name].mod
        unit = UNITS[mod.kind]
        grp, leaf = unit.param_path
        w = params["layers"][grp][leaf][unit.index(mod)]
        gone = np.asarray(db[name].order[:removed], np.int64)
        rows = (gone[:, None] * mod.group_size
                + np.arange(mod.group_size)).reshape(-1)
        if bool(w[torch.from_numpy(rows).to(w.device)].any()):
            return False
    return True


def check_small_train(torch, cfg, p_cpu, db, assignment, what="small"):
    """Phase 3, training: 5 steps of ``make_train_step`` on a small
    model's stitched member, the dense model as teacher, the member's
    masks and 2 microbatches, on the card and on the CPU: every metric
    within 1e-3 relative (ROADMAP's loss tolerance), the masked rows
    exactly 0 on both. Returns, for an MoE model, the most (token,
    expert) assignments that one MoE layer sent past its experts'
    capacity in a microbatch (0 without experts)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.database import apply_assignment
    from repro_torch.core.pipeline import masks_from_assignment
    from repro_torch.data import make_batch_np
    from repro_torch.models import moe
    from repro_torch.models.transformer import tree_to
    from repro_torch.train import make_train_state, make_train_step

    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=5,
                       microbatches=2, distill_logit=1.0, distill_token=0.5)
    student = apply_assignment(cfg, p_cpu, db, assignment)
    masks = masks_from_assignment(cfg, student, db, assignment)
    overflow = []
    route = moe.route

    def counting_route(router, xf, k):
        out = route(router, xf, k)
        counts = torch.bincount(out[2].reshape(-1), minlength=router.shape[-1])
        overflow.append(int((counts - moe.capacity(xf.shape[0], cfg))
                            .clamp_min(0).sum()))
        return out

    logs, zero = {}, {}
    moe.route = counting_route
    try:
        for dev in ("cpu", "cuda"):
            step = make_train_step(cfg, tcfg, teacher_params=p_cpu,
                                   masks=masks, device=dev)
            state = make_train_state(cfg, tree_to(student, dev), tcfg)
            logs[dev] = []
            for i in range(5):
                state, m = step(state, make_batch_np(cfg, 8, 64, seed=2,
                                                     step=i))
                logs[dev].append({k: float(v) for k, v in m.items()})
            zero[dev] = rows_zero(torch, state.params, db, assignment)
    finally:
        moe.route = route
    worst = max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-30)
                for w, g in zip(logs["cpu"], logs["cuda"]) for k in w)
    over = max(overflow, default=0)
    print(f"{what} train: 5 steps (teacher, masks, 2 microbatches) card vs "
          f"CPU: worst metric relative error {worst:.3e} (tol 1e-3); "
          f"losses card {[round(m['loss'], 5) for m in logs['cuda']]}; "
          f"masked rows 0: {zero}"
          + (f"; most assignments past an expert's capacity in a "
             f"microbatch's layer {over}" if cfg.num_experts else ""))
    check(worst <= 1e-3, f"{what} train-step metrics differ between card "
          "and CPU")
    check(all(zero.values()), f"{what}: a masked row is not 0 after "
          "training")
    return over


def check_small_serving(torch):
    """Phase 3, serving: a 2-layer GPT-2 with head dim 64 in fp32 and flash
    prefill, on the card (the flash kernel) and on the CPU (its plain
    version): prefill logits within 1e-4 of their scale, and the engine's
    greedy tokens equal for a few requests."""
    from repro_torch.configs import GPT2_SMALL
    from repro_torch.models import model_init, serve_prefill
    from repro_torch.models.transformer import tree_to
    from repro_torch.serve import (DenseServeModel, ServeEngine,
                                   synthetic_requests)

    cfg = GPT2_SMALL.replace(name="gpt2-2l-d64", num_layers=2, d_model=256,
                             num_heads=4, num_kv_heads=4, d_ff=1024,
                             vocab_size=512, dtype="float32",
                             attn_impl="flash_lax")
    p_cpu = model_init(cfg, torch.Generator().manual_seed(2), device="cpu")
    p_gpu = tree_to(p_cpu, "cuda")
    reqs = synthetic_requests(cfg, 4, seed=4, rate=100.0,
                              prompt_lens=(40, 77, 128), steps_range=(8, 16))
    prompt = torch.from_numpy(reqs[0].tokens[None])
    lg_cpu, _ = serve_prefill(cfg, p_cpu, {"tokens": prompt}, max_len=160)
    lg_gpu, _ = serve_prefill(cfg, p_gpu, {"tokens": prompt.cuda()},
                              max_len=160)
    err = float((lg_gpu.cpu() - lg_cpu).abs().max())
    scale = float(lg_cpu.abs().max())
    print(f"small serving: {cfg.name} prefill logits card vs CPU "
          f"max_abs_err={err:.3e} (scale {scale:.3e}, tol 1e-4*scale)")
    check(err <= 1e-4 * scale, "prefill logits disagree between card and CPU")
    tokens = {}
    for dev, params in (("cpu", p_cpu), ("cuda", p_gpu)):
        eng = ServeEngine(DenseServeModel(cfg, params, 160), num_slots=2)
        tokens[dev] = [r.tokens for r in eng.run(reqs).records]
    print(f"small serving: greedy tokens of {len(reqs)} requests card == "
          f"CPU: {tokens['cuda'] == tokens['cpu']}")
    check(tokens["cuda"] == tokens["cpu"], "served tokens differ")


def check_small_ssm(torch, kernels):
    """Phase 3, Mamba-2: the reference's smoke shape (2 layers, d_model
    128, 8 SSD heads x 32, state 16, chunk 32, vocab 512) in fp32 on the
    card (the SSD kernel) and on the CPU (its plain version), on the same
    weights (``check_small_scan_model``)."""
    from repro_torch.configs import MAMBA2_2P7B
    cfg = MAMBA2_2P7B.replace(name="mamba2-smoke", num_layers=2, d_model=128,
                              ssm_state=16, ssm_head_dim=32, ssm_chunk=32,
                              vocab_size=512, dtype="float32")
    check_small_scan_model(torch, kernels, cfg, 3, "Mamba-2")


def check_small_hybrid(torch, kernels):
    """Phase 3, Hymba: the reference's smoke shape
    (``smoke_config("hymba-1.5b")``: 2 layers, d_model 128, 4 query heads
    on 1 KV head of 32 with a 64-token window, 4 SSD heads x 32, state 16,
    chunk 32, d_ff 256, vocab 512) in fp32 on the card and on the CPU, on
    the same weights (``check_small_scan_model``)."""
    from repro_torch.configs import smoke_config
    check_small_scan_model(
        torch, kernels, smoke_config("hymba-1.5b").replace(dtype="float32"),
        5, "Hymba")


def check_small_scan_model(torch, kernels, cfg, seed: int, what: str):
    """A small model with SSD heads in fp32 on the card (the SSD kernel)
    and on the CPU (its plain version), on the same weights: logits within
    1e-4 of their scale, Hessians within 1e-4 of theirs, database errors
    as for the small GPT-2, greedy tokens equal, then a train step
    (``check_small_ssm_train``)."""
    import numpy as np
    from repro_torch.core.database import build_database
    from repro_torch.core.hessian import collect_hessians
    from repro_torch.data import calibration_batches
    from repro_torch.models import forward, generate, model_init
    from repro_torch.models.transformer import tree_to

    p_cpu = model_init(cfg, torch.Generator().manual_seed(seed),
                       device="cpu")
    p_gpu = tree_to(p_cpu, "cuda")
    calib = calibration_batches(cfg, 16, 64, batch=8)
    tokens = calib[0]["tokens"]
    lg_cpu = forward(cfg, p_cpu, tokens)["logits"]
    lg_gpu = forward(cfg, p_gpu, tokens.cuda())["logits"].cpu()
    err, scale = float((lg_gpu - lg_cpu).abs().max()), float(
        lg_cpu.abs().max())
    print(f"small {what}: logits card vs CPU max_abs_err={err:.3e} (scale "
          f"{scale:.3e}, tol 1e-4*scale)")
    check(err <= 1e-4 * scale, f"{what} logits disagree between card and "
          "CPU")
    h_cpu = collect_hessians(cfg, p_cpu, calib, device="cpu")
    h_gpu = collect_hessians(cfg, p_gpu, calib, device="cuda")
    herr = max(float((h_gpu[k].cpu() - h_cpu[k]).abs().max()) for k in h_cpu)
    hscale = max(float(h.abs().max()) for h in h_cpu.values())
    print(f"small {what}: Hessians of {list(h_cpu)} card vs CPU "
          f"max_abs_err={herr:.3e} (scale {hscale:.3e}, tol 1e-4*scale)")
    check(herr <= 1e-4 * hscale,
          f"{what} Hessians disagree between card and CPU")
    compare_databases(np, build_database(cfg, p_cpu, h_cpu, device="cpu"),
                      build_database(cfg, p_gpu, h_cpu, device="cuda"),
                      f"small {what}")
    prompt = tokens[:2, :40]
    t_cpu = generate(cfg, p_cpu, prompt, 12)
    t_gpu = generate(cfg, p_gpu, prompt.cuda(), 12).cpu()
    print(f"small {what}: greedy tokens of {tuple(prompt.shape)} prompts, "
          f"12 steps, card == CPU: {torch.equal(t_gpu, t_cpu)}")
    check(torch.equal(t_gpu, t_cpu), f"{what} greedy tokens differ")
    check_small_ssm_train(torch, kernels, cfg, p_cpu, what)


def cross_gates(params):
    """The cross-attention gates: a decoder layer's ``layers.xattn`` or a
    cross group's ``cross.xattn``."""
    owner = params["cross"] if "cross" in params else params["layers"]
    return owner["xattn"]["gate"]


def open_gates(torch, params, seed: int) -> None:
    """Set every cross-attention gate (each decoder layer's, or each cross
    group's), in place, from a seeded draw whose tanh lies in [0.5, 0.9]:
    at their initial 0 the frames would reach no logit, and a check could
    not see the encoder or the cross-attention."""
    import numpy as np
    gate = cross_gates(params)
    draw = np.random.default_rng(seed).uniform(0.5, 0.9, tuple(gate.shape))
    gate.copy_(torch.from_numpy(np.arctanh(draw)))


# phase 3's models with frames, (config name, changes, seed, label): the
# reference's smoke Whisper (2 decoder and 2 encoder layers, d_model 128, 4
# heads of 32, d_ff 256, 16 frames of 128, vocab 512), its smoke
# Llama-3.2-Vision (2 self layers and 1 cross group, 4 heads on 1 KV head
# of 32, 16 frames of 128) and the same with two cross groups over frames
# of 96 (``frontend_proj``)
SMALL_CROSS = [
    ("whisper-large-v3", {}, 6, "Whisper"),
    ("llama-3.2-vision-11b", {}, 7, "VLM"),
    ("llama-3.2-vision-11b", {"frontend_dim": 96, "num_layers": 4}, 8,
     "VLM two groups"),
]


def check_small_cross(torch, name, changes, seed, what):
    """Phase 3, a model with frames: ``smoke_config(name)`` with
    ``changes`` in fp32, its cross-attention gates opened
    (``open_gates``), on the card and on the CPU on the same weights and
    frames: logits within 1e-4 of their scale, Hessians within 1e-4 of
    theirs, database errors and orders as for the small GPT-2, and greedy
    tokens through the cross cache (``generate(frontend=...)``) equal."""
    import numpy as np
    from repro_torch.configs import smoke_config
    from repro_torch.core.database import build_database
    from repro_torch.core.hessian import collect_hessians
    from repro_torch.data import calibration_batches
    from repro_torch.models import forward, generate, model_init
    from repro_torch.models.transformer import tree_to

    cfg = smoke_config(name).replace(dtype="float32", **changes)
    p_cpu = model_init(cfg, torch.Generator().manual_seed(seed),
                       device="cpu")
    open_gates(torch, p_cpu, seed)
    p_gpu = tree_to(p_cpu, "cuda")
    calib = calibration_batches(cfg, 16, 64, batch=8)
    tokens, frames = calib[0]["tokens"], calib[0]["frontend"]
    lg_cpu = forward(cfg, p_cpu, tokens, frontend_embeds=frames)["logits"]
    lg_gpu = forward(cfg, p_gpu, tokens.cuda(),
                     frontend_embeds=frames.cuda())["logits"].cpu()
    err, scale = float((lg_gpu - lg_cpu).abs().max()), float(
        lg_cpu.abs().max())
    print(f"small {what}: gates {cross_gates(p_cpu).tolist()}; logits card "
          f"vs CPU max_abs_err={err:.3e} (scale {scale:.3e}, tol "
          f"1e-4*scale)")
    check(err <= 1e-4 * scale, f"{what} logits disagree between card and "
          "CPU")
    h_cpu = collect_hessians(cfg, p_cpu, calib, device="cpu")
    h_gpu = collect_hessians(cfg, p_gpu, calib, device="cuda")
    herr = max(float((h_gpu[k].cpu() - h_cpu[k]).abs().max()) for k in h_cpu)
    hscale = max(float(h.abs().max()) for h in h_cpu.values())
    print(f"small {what}: Hessians of {list(h_cpu)} card vs CPU "
          f"max_abs_err={herr:.3e} (scale {hscale:.3e}, tol 1e-4*scale)")
    check(herr <= 1e-4 * hscale,
          f"{what} Hessians disagree between card and CPU")
    compare_databases(np, build_database(cfg, p_cpu, h_cpu, device="cpu"),
                      build_database(cfg, p_gpu, h_cpu, device="cuda"),
                      f"small {what}")
    prompt, fe = tokens[:2, :40], frames[:2]
    t_cpu = generate(cfg, p_cpu, prompt, 12, frontend=fe)
    t_gpu = generate(cfg, p_gpu, prompt.cuda(), 12,
                     frontend=fe.cuda()).cpu()
    print(f"small {what}: greedy tokens of {tuple(prompt.shape)} prompts "
          f"with their frames, 12 steps through the cross cache, card == "
          f"CPU: {torch.equal(t_gpu, t_cpu)}")
    check(torch.equal(t_gpu, t_cpu), f"{what} greedy tokens differ")


def ssm_step_grads(torch, cfg, params, teacher, batch):
    """(loss, gradients) of one distillation train step's loss on
    ``params`` (logit 1.0 and token 0.5 distillation against ``teacher``),
    under the train step's deterministic algorithms."""
    from repro_torch.distill.losses import distillation_loss
    from repro_torch.optim.adamw import tree_leaves, tree_map
    from repro_torch.train.train_step import deterministic_algorithms
    live = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                    params)
    with deterministic_algorithms():
        total, _ = distillation_loss(cfg, live, teacher, batch, l_logit=1.0,
                                     l_token=0.5)
        grads = torch.autograd.grad(total, tree_leaves(live))
    return float(total.detach()), grads


def check_small_ssm_train(torch, kernels, cfg, p_cpu, what="Mamba-2"):
    """Phase 3, a Mamba-2 (or Hymba) train step: the loss and every
    gradient of one distillation step (8 x 64 tokens, two chunks of 32, a
    teacher of another seed) on the card (the SSD forward and backward
    kernels) and
    on the CPU (their plain versions): the loss within 1e-3 relative
    (ROADMAP's loss tolerance), each gradient within 1e-4 of its own
    scale (SSD_TOL for the model's fp32 B and C); the backward kernel
    launched once a layer."""
    from repro_torch.data import make_batch_np
    from repro_torch.models import model_init
    from repro_torch.models.transformer import tree_to
    teacher = model_init(cfg, torch.Generator().manual_seed(4), device="cpu")
    batch = make_batch_np(cfg, 8, 64, seed=5)
    loss_cpu, g_cpu = ssm_step_grads(torch, cfg, p_cpu, teacher, batch)
    before = kernels.ssd_intra_chunk_backward.launches
    loss_gpu, g_gpu = ssm_step_grads(
        torch, cfg, tree_to(p_cpu, "cuda"), tree_to(teacher, "cuda"),
        {k: v.cuda() for k, v in batch.items()})
    torch.cuda.synchronize()
    launched = kernels.ssd_intra_chunk_backward.launches - before
    lerr = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    worst = max(float((a.cpu() - b).abs().max()) / max(
        float(b.abs().max()), 1e-30) for a, b in zip(g_gpu, g_cpu))
    print(f"small {what} train step: loss card {loss_gpu:.6f} CPU "
          f"{loss_cpu:.6f} (relative error {lerr:.3e}, tol 1e-3); "
          f"{len(g_cpu)} gradients, worst error {worst:.3e} of the "
          f"gradient's scale (tol {SSD_TOL['float32']:g}); backward "
          f"kernel launches {launched}")
    check(lerr <= 1e-3, f"{what} train-step loss differs between card and "
          "CPU")
    check(worst <= SSD_TOL["float32"],
          f"{what} gradients differ between card and CPU")
    check(launched == cfg.num_layers,
          f"the SSD backward kernel launched {launched} times, not once a "
          "layer")


def check_small_moe(torch):
    """Phase 3, MoE: the reference's smoke Phi-3.5-MoE (2 layers, d_model
    128, 4 query heads of 32 on 1 KV head, 4 experts top-2 of d_ff 256,
    vocab 512) in fp32 on the card and on the CPU, on the same weights:
    logits within 1e-4 of their scale, Hessians within 1e-4 of theirs;
    then in each MoE prune mode the database errors as for the small
    GPT-2, the stitched members' losses within 1e-3 relative, and the
    engine's greedy tokens (flash prefill) equal for the dense model and a
    shrunk member; in expert mode last, five train steps of the 2x member
    (``check_small_train``) with an expert over its capacity."""
    import numpy as np
    from repro_torch.configs import smoke_config
    from repro_torch.core.database import apply_assignment, build_database
    from repro_torch.core.hessian import collect_hessians
    from repro_torch.core.latency import build_table
    from repro_torch.core.oneshot import calib_loss_fn
    from repro_torch.core.shrink import shrink
    from repro_torch.core.spdy import search_family
    from repro_torch.data import calibration_batches
    from repro_torch.models import forward, model_init
    from repro_torch.models.transformer import tree_to
    from repro_torch.runtime.costmodel import InferenceEnv
    from repro_torch.serve import (DenseServeModel, PrunedServeModel,
                                   ServeEngine, synthetic_requests)

    base = smoke_config("phi3.5-moe-42b-a6.6b").replace(dtype="float32")
    p_cpu = model_init(base, torch.Generator().manual_seed(4), device="cpu")
    p_gpu = tree_to(p_cpu, "cuda")
    # 1536 tokens: about 768 rows an expert for its 256 inputs (full rank)
    calib = calibration_batches(base, 24, 64, batch=8)
    tokens = calib[0]["tokens"]
    lg_cpu = forward(base, p_cpu, tokens)["logits"]
    lg_gpu = forward(base, p_gpu, tokens.cuda())["logits"].cpu()
    err, scale = float((lg_gpu - lg_cpu).abs().max()), float(
        lg_cpu.abs().max())
    print(f"small MoE: logits card vs CPU max_abs_err={err:.3e} (scale "
          f"{scale:.3e}, tol 1e-4*scale)")
    check(err <= 1e-4 * scale, "MoE logits disagree between card and CPU")
    h_cpu = collect_hessians(base, p_cpu, calib, device="cpu")
    h_gpu = collect_hessians(base, p_gpu, calib, device="cuda")
    herr = max(float((h_gpu[k].cpu() - h_cpu[k]).abs().max()) for k in h_cpu)
    hscale = max(float(h.abs().max()) for h in h_cpu.values())
    print(f"small MoE: Hessians of {len(h_cpu)} modules card vs CPU "
          f"max_abs_err={herr:.3e} (scale {hscale:.3e}, tol 1e-4*scale)")
    check(herr <= 1e-4 * hscale, "MoE Hessians disagree between card and CPU")

    env = InferenceEnv(batch=4, seq=64, hw=None)
    reqs = synthetic_requests(base, 4, seed=5, rate=100.0,
                              prompt_lens=(40, 77, 128), steps_range=(8, 16))
    loss_cpu = calib_loss_fn(base, calib[:1], device="cpu")
    loss_gpu = calib_loss_fn(base, calib[:1], device="cuda")
    for mode in ("width", "expert"):
        cfg = base.replace(moe_prune_unit=mode)
        db_cpu = build_database(cfg, p_cpu, h_cpu, device="cpu")
        db_gpu = build_database(cfg, p_gpu, h_cpu, device="cuda")
        compare_databases(np, db_cpu, db_gpu, f"small MoE ({mode})")
        table = build_table(cfg, env, backend="measure", device="cpu")
        res = search_family(db_cpu, table, [1.5, 2.0], steps=32, seed=0)
        for t, r in res.items():
            lc = loss_cpu(apply_assignment(cfg, p_cpu, db_cpu, r.assignment))
            lg = loss_gpu(apply_assignment(cfg, p_gpu, db_gpu, r.assignment))
            print(f"small MoE ({mode}): {t}x member loss card {lg:.6f} CPU "
                  f"{lc:.6f} (tol 1e-3 relative)")
            check(abs(lg - lc) <= 1e-3 * abs(lc),
                  f"MoE {mode} {t}x member losses differ")
        # one shrunk member from the CPU's database on both devices, so the
        # two serve the same model
        a = res[2.0].assignment
        members = {"2.0x": {d: PrunedServeModel(shrink(cfg, p, db_cpu, a,
                                                       device=d), 160)
                            for d, p in (("cpu", p_cpu), ("cuda", p_gpu))}}
        if mode == "width":  # the dense model is the same in both modes
            members["dense"] = {d: DenseServeModel(cfg, p, 160) for d, p in
                                (("cpu", p_cpu), ("cuda", p_gpu))}
        widths = [l.expert_ff for l in members["2.0x"]["cpu"].pm.layers]
        for member, by_dev in members.items():
            served = {d: [r.tokens for r in ServeEngine(
                m, num_slots=2).run(reqs).records] for d, m in by_dev.items()}
            same = served["cuda"] == served["cpu"]
            print(f"small MoE ({mode}): {member} member's greedy tokens of "
                  f"{len(reqs)} requests card == CPU: {same}"
                  + (f" (expert widths {widths})" if member != "dense"
                     else ""))
            check(same, f"MoE {mode} {member}: served tokens differ")
        if mode == "expert":
            # the member's train steps, with dropped experts' wd rows
            # masked; the dispatch must overflow, so that its dropped
            # slot's scatters and gathers run backward on the card
            over = check_small_train(torch, cfg, p_cpu, db_cpu, a,
                                     f"small MoE ({mode})")
            check(over > 0, "small MoE train: no expert overflowed its "
                  "capacity")


def check_ceiling(res, expected, what):
    """The run's measured table's ceiling, its dense runtime over the
    logits head that no unit removes, printed and held to at least 0.95 of
    ``expected`` (the ceiling measured when the phase's fixed targets were
    chosen), so that a table that misprices the head or the layers fails
    here and not only through the targets it would let slip."""
    ceiling = res.dense_runtime / res.table.base
    print(f"{what}: measured table dense runtime {res.dense_runtime * 1e3:.4f}"
          f" ms over its logits head {res.table.base * 1e3:.4f} ms: ceiling "
          f"{ceiling:.4f}x (expected at least 0.95 x {expected}x)")
    check(ceiling >= 0.95 * expected,
          f"{what}: the measured table's ceiling {ceiling:.4f}x is below "
          f"0.95 x {expected}x")


def main_model(torch):
    """Phase 4's model on the card and its calibration batches: GPT-2
    small at MAIN_LAYERS from seed 0, 32 x 512 tokens in batches of 8."""
    from repro_torch.configs import GPT2_SMALL
    from repro_torch.data import calibration_batches
    from repro_torch.models import model_init

    cfg = GPT2_SMALL.replace(num_layers=MAIN_LAYERS)
    params = model_init(cfg, torch.Generator().manual_seed(0), device="cuda")
    calib = calibration_batches(cfg, 32, 512, batch=8)
    torch.cuda.synchronize()
    return cfg, params, calib


def run_main_path(torch, kernels):
    """Phase 4: oneshot_prune on full-width GPT-2 small at MAIN_LAYERS."""
    from repro_torch.core.oneshot import oneshot_prune
    from repro_torch.runtime.costmodel import InferenceEnv

    t0 = time.perf_counter()
    cfg, params, calib = main_model(torch)
    setup_s = time.perf_counter() - t0
    drawn = leaf_digests(params, calib)
    env = InferenceEnv(batch=16, seq=128, mode="prefill", hw=None)
    targets = MAIN_TARGETS

    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = oneshot_prune(cfg, params, calib, env, targets,
                        latency_backend="measure", latency_kw=LATENCY_KW,
                        search_steps=48, search_pop=16, seed=0,
                        device="cuda")
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels.KERNELS}

    print(f"main path: {cfg.name} layers={cfg.num_layers} "
          f"d_model={cfg.d_model} d_ff={cfg.d_ff} vocab={cfg.vocab_size} "
          f"dtype={cfg.dtype}; calibration 32 x 512 tokens in batches of 8; "
          f"env batch={env.batch} seq={env.seq} {env.mode}, measured table "
          f"({LATENCY_KW}); targets {targets}")
    print(f"main path: setup (weights + tokens) {setup_s:.3f} s, "
          f"oneshot_prune {total_s:.3f} s, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print("stage seconds: " + json.dumps(
        {k: round(v, 4) for k, v in res.stage_seconds.items()}))
    print(f"main path launches: {launches}")
    print(f"dense: table runtime {res.dense_runtime * 1e3:.4f} ms, "
          f"calibration loss {res.dense_loss:.4f}")
    check_ceiling(res, MAIN_CEILING, "main path")
    for t in targets:
        v = res.variants[t]
        removed = sum(v.assignment.values())
        print(f"  target {t}x: speedup {v.speedup:.3f}x, runtime "
              f"{v.runtime * 1e3:.4f} ms, loss {v.calib_loss:.4f}, "
              f"structures removed {removed}, evals {v.search.n_evals}")
        check(v.speedup >= t, f"target {t}x not met: {v.speedup:.4f}x")
        check(math.isfinite(v.calib_loss), f"target {t}x: non-finite loss")
        for grp, leaf in (("attn", "wo"), ("ffn", "wd")):
            w = v.params["layers"][grp][leaf]
            check(w.shape == params["layers"][grp][leaf].shape
                  and bool(torch.isfinite(w).all()),
                  f"{t}x: {leaf} has the wrong shape or non-finite values")
    check(math.isfinite(res.dense_loss), "non-finite dense loss")
    for name in ONESHOT_KERNELS:
        check(launches[name] > 0, f"{name} never launched on the main path")
    distinct = len({tuple(sorted(res.variants[t].assignment.items()))
                    for t in targets})
    print(f"loss-scored family: {distinct} distinct member(s) for "
          f"{len(targets)} targets (on seeded random weights pruning can "
          f"lower the calibration loss, so one member may win every target)")
    fam = check_prior_family(torch, cfg, params, calib, res, targets)
    check_table_spread(cfg, env, res)
    # the weights and tokens that phases 5, 8, 9, 16-18 take must be the
    # ones drawn (phase 18's ranks draw them again)
    now = leaf_digests(params, calib)
    check(now == drawn, "phase 4 changed its weights or tokens: "
          + str(sorted(k for k in drawn if now.get(k) != drawn[k])))
    return launches, cfg, params, calib, res.db, res.table, fam


def check_prior_family(torch, cfg, params, calib, res, targets):
    """The family searched again on the main path's own database and
    table, scored by the analytic prior sum (``eval_with_loss=False``):
    a score that grows with every removal, so each target must get its
    own member and the speedups must rise with the targets."""
    from repro_torch.core.database import apply_assignment
    from repro_torch.core.oneshot import calib_loss_fn
    from repro_torch.core.spdy import search_family

    fam = search_family(res.db, res.table, targets, steps=48, pop=16, seed=0)
    loss = calib_loss_fn(cfg, calib[:1], device="cuda")
    speedups = []
    for t in targets:
        r = fam[t]
        lv = loss(apply_assignment(cfg, params, res.db, r.assignment))
        print(f"  prior-scored {t}x: speedup {r.speedup:.4f}x, runtime "
              f"{r.runtime * 1e3:.4f} ms, prior score {r.score:.4f}, "
              f"structures removed {sum(r.assignment.values())}, "
              f"loss {lv:.4f}")
        check(r.speedup >= t, f"prior-scored {t}x not met: {r.speedup:.4f}x")
        check(math.isfinite(lv), f"prior-scored {t}x: non-finite loss")
        speedups.append(r.speedup)
    check(all(a < b for a, b in zip(speedups, speedups[1:])),
          f"prior-scored family is degenerate: speedups {speedups}")
    return fam


def check_table_spread(cfg, env, res, rebuilds: int = 2):
    """The measured table built again with the same settings: the spread
    of its dense runtime within this run."""
    from repro_torch.core.latency import build_table
    from repro_torch.core.structures import registry

    mods = registry(cfg)
    dense = [res.dense_runtime * 1e3] + [
        build_table(cfg, env, backend="measure", device="cuda",
                    **LATENCY_KW).dense_runtime(mods) * 1e3
        for _ in range(rebuilds)]
    print(f"measured table dense runtime over {len(dense)} builds: "
          + ", ".join(f"{v:.4f}" for v in dense)
          + f" ms (spread {(max(dense) - min(dense)) / min(dense):.2%})")


# phase 5: GPT-2 small served with flash prefill; the stream's prompts
# pad to the 128/256/512/1024 buckets. 32 requests arrive in well under
# a second, faster than 8 slots serve them: tokens/s is the saturated
# throughput. The decode is host-bound, so the phase's time grows with
# the requests: 256 took 160-220 s of the script's 1200 s limit, 128 at 6
# layers 60-68 s, 64 a 24.8 s stream (33.7 s phase) on an NVIDIA H100
# 80GB HBM3 at 700 W; with phase 15 added the script took 1155 s, so 32
SERVE = {"max_len": 1024, "slots": 8, "requests": 32}
STREAM = {"seed": 0, "rate": 50.0, "prompt_lens": (128, 256, 512, 768),
          "steps_range": (16, 64)}
# shrunk vs stitched logits, bf16 through every layer in both (different
# GEMM shapes round differently): max abs error within 5e-2 of the scale
STITCHED_TOL = 5e-2


def _alone(torch, model, req, max_len):
    """A request's greedy tokens decoded by itself (batch 1, its exact
    prompt length): ``generate`` for the dense model, the pruned
    runtime's prefill and decode loop for a shrunk member."""
    from repro_torch.models import generate
    from repro_torch.models.pruned import decode_step_pruned, prefill_pruned
    from repro_torch.serve import DenseServeModel
    prompt = torch.from_numpy(req.tokens[None]).cuda()
    if isinstance(model, DenseServeModel):
        return generate(model.cfg, model.params, prompt, req.steps,
                        max_len=max_len)[0].tolist()
    logits, cache = prefill_pruned(model.pm, prompt, max_len)
    toks = [int(logits[0, -1].argmax())]
    for _ in range(req.steps - 1):
        logits, cache = decode_step_pruned(
            model.pm, cache, torch.tensor([[toks[-1]]], device="cuda"))
        toks.append(int(logits[0, -1].argmax()))
    return toks


def serve_family(torch, kernels, params, calib, db, fam):
    """Phase 5: the prior-scored family shrunk and served at full width."""
    from repro_torch.configs import GPT2_SMALL
    from repro_torch.core.shrink import shrink, shrink_from_stitched
    from repro_torch.models import forward
    from repro_torch.models.pruned import forward_pruned, kv_cache_bytes
    from repro_torch.serve import (DENSE_TARGET, DenseServeModel,
                                   FamilyServer, PrunedServeModel,
                                   ServeEngine, synthetic_requests)

    cfg = GPT2_SMALL.replace(num_layers=MAIN_LAYERS)
    assignments = {t: r.assignment for t, r in fam.items()}
    t0 = time.perf_counter()
    server = FamilyServer(cfg, params, db, assignments,
                          max_len=SERVE["max_len"], num_slots=SERVE["slots"])
    torch.cuda.synchronize()
    print(f"serving: {cfg.name} attn_impl={cfg.attn_impl} (engines run "
          f"{server.members[DENSE_TARGET].model.cfg.attn_impl}) "
          f"dtype={cfg.dtype}, FamilyServer of {sorted(server.members)} "
          f"stood up in {time.perf_counter() - t0:.3f} s ({SERVE})")

    # shrink_from_stitched against shrink on one member: bit-equal leaves
    t_chk = max(assignments)
    a = assignments[t_chk]
    dev_pm = shrink_from_stitched(cfg, server.snapshots.apply(params, a),
                                  db, a)
    host_pm = shrink(cfg, params, db, a, device="cuda")
    hl, dl = (_leaves([l.params for l in pm.layers] + [pm.globals_])
              for pm in (host_pm, dev_pm))
    same = len(hl) == len(dl) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(hl, dl))
    print(f"serving: {t_chk}x shrink_from_stitched == shrink: {len(hl)} "
          f"leaves bit-equal: {same}")
    check(same and [l.kv_groups for l in host_pm.layers]
          == [l.kv_groups for l in dev_pm.layers],
          "shrink_from_stitched differs from shrink")
    del host_pm, dev_pm

    # each member's shrunk logits against its stitched dense model's
    tokens = calib[0]["tokens"].cuda()
    with torch.no_grad():
        for t, eng in sorted(server.members.items()):
            if t == DENSE_TARGET:
                continue
            stitched = server.snapshots.apply(params, assignments[t])
            want = forward(eng.model.cfg, stitched, tokens)["logits"]
            got = forward_pruned(eng.model.pm, tokens)
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            finite = bool(torch.isfinite(got).all()) \
                and bool(torch.isfinite(want).all())
            print(f"serving: {t}x shrunk vs stitched logits on "
                  f"{tuple(tokens.shape)} calibration tokens: max_abs_err="
                  f"{err:.4e} (scale {scale:.4e}, tol {STITCHED_TOL:g}*scale),"
                  f" finite {finite}")
            check(finite and err <= STITCHED_TOL * scale,
                  f"{t}x: shrunk logits disagree with the stitched model")
            del stitched, want, got

    t0 = time.perf_counter()
    server.warmup(STREAM["prompt_lens"])
    torch.cuda.synchronize()
    print(f"serving: warm-up {time.perf_counter() - t0:.3f} s")

    reqs = synthetic_requests(cfg, SERVE["requests"], **STREAM)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    reports = {t: eng.run(reqs) for t, eng in sorted(server.members.items())}
    routed = server.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels.KERNELS}
    print(f"serving main path: {len(reqs)} requests through each of "
          f"{len(reports)} members, then routed, in {wall:.3f} s; launches "
          f"{launches}")
    for name in SERVING_KERNELS:
        check(launches[name] > 0, f"{name} never launched while serving")

    dh, L = cfg.resolved_head_dim, cfg.num_layers
    for t, rep in sorted(reports.items()):
        eng = server.members[t]
        m = rep.as_dict()
        if t == DENSE_TARGET:
            n_params = sum(x.numel() for x in _leaves(params))
            want_kv = 2 * SERVE["slots"] * SERVE["max_len"] * L \
                * cfg.num_kv_heads * dh * 2
        else:
            n_params = eng.model.pm.num_params()
            want_kv = kv_cache_bytes(eng.model.pm, SERVE["slots"],
                                     SERVE["max_len"])
        print(f"  member {t}x: params {n_params}, KV bytes "
              f"{m['kv_cache_bytes']}, prefill {m['prefill_ms_mean']:.4f} ms "
              f"(mean), decode {m['decode_ms_per_token_mean']:.4f} ms/token, "
              f"{m['tokens_per_s']:.2f} tokens/s, p50 {m['p50_ms']:.3f} ms, "
              f"p99 {m['p99_ms']:.3f} ms, {m['total_tokens']} tokens in "
              f"{rep.steps} steps, busy {m['wall_s']:.4f} s")
        check(m["kv_cache_bytes"] == want_kv,
              f"{t}x: KV bytes {m['kv_cache_bytes']} != {want_kv}")
    for t, rep in sorted(routed.items()):
        m = rep.as_dict()
        print(f"  routed to {t}x: {m['requests']} requests, prefill "
              f"{m['prefill_ms_mean']:.4f} ms, decode "
              f"{m['decode_ms_per_token_mean']:.4f} ms/token, "
              f"{m['tokens_per_s']:.2f} tokens/s, p50 {m['p50_ms']:.3f} ms, "
              f"p99 {m['p99_ms']:.3f} ms")
        check(all(server.route(r.latency_class) == t for r in rep.records),
              f"routing sent a request to the wrong member {t}x")

    # engine tokens against per-request decoding, two requests per member.
    # As served (bf16), batch 8 and batch 1 GEMMs round differently, so a
    # near-tie may flip a greedy token: reported. In fp32 (TF32 off) the
    # engine must equal per-request decoding token for token.
    pick = reqs[:2]
    cfg32 = cfg.replace(dtype="float32")
    for t, eng in sorted(server.members.items()):
        bf16_same = [reports[t].records[i].tokens
                     == _alone(torch, eng.model, r, SERVE["max_len"])
                     for i, r in enumerate(pick)]
        if t == DENSE_TARGET:
            model32 = DenseServeModel(cfg32, params, SERVE["max_len"])
        else:
            a = assignments[t]
            model32 = PrunedServeModel(shrink_from_stitched(
                cfg32, server.snapshots.apply(params, a), db, a),
                SERVE["max_len"])
        eng32 = ServeEngine(model32, SERVE["slots"])
        served32 = [r.tokens for r in eng32.run(pick).records]
        alone32 = [_alone(torch, model32, r, SERVE["max_len"]) for r in pick]
        print(f"  member {t}x: engine == per-request decoding for requests "
              f"{[r.rid for r in pick]} (prompts "
              f"{[r.prompt_len for r in pick]}, {[r.steps for r in pick]} "
              f"tokens): fp32 {served32 == alone32}, bf16 as served "
              f"{bf16_same}")
        check(served32 == alone32,
              f"{t}x: engine tokens differ from per-request decoding")
        del model32, eng32
    return launches


def serve_cli(torch, kernels):
    """Phase 5, the CLI as a user runs it (``python -m
    repro_torch.launch.serve --arch gpt2-small``, its defaults): it must
    serve every request with finite metrics and launch the flash kernel."""
    from repro_torch.launch import serve

    kernels.reset_launch_counts()
    m = serve.main(["--arch", "gpt2-small"])
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kernels.KERNELS}
    print(f"serving CLI: launches {launches}")
    check(m["requests"] > 0 and m["total_tokens"] > 0
          and all(math.isfinite(v) for v in m.values()),
          f"serving CLI: bad metrics {m}")
    for name in SERVING_KERNELS:
        check(launches[name] > 0, f"{name} never launched by the serving CLI")


# phase 8: the top member of phase 4's prior-scored family (1.56x, the
# most structures removed) finetuned against the dense model with the
# reference's gradual defaults (src/repro/core/pipeline.py gradual_prune)
# on batches of 8 x 512; run A takes 40 steps, run B stops at 30 and
# resumes from its step-20 checkpoint
TRAIN_KW = {"learning_rate": 8e-5, "warmup_steps": 5, "total_steps": 40,
            "distill_logit": 1.0, "distill_token": 0.5}
TRAIN_BATCH, TRAIN_SEQ = 8, 512
TRAIN_EVERY, TRAIN_STOP = 20, 30
TRAIN_CLI = ["--arch", "gpt2-small", "--steps", "10", "--batch", "8",
             "--seq", "512"]


def _same_state(torch, a, b):
    """{part: bit-equal} for params, m, v and count of two TrainStates."""
    from repro_torch.optim.adamw import tree_leaves

    def equal(x, y):
        lx, ly = tree_leaves(x), tree_leaves(y)
        return len(lx) == len(ly) and all(
            u.dtype == w.dtype and torch.equal(u, w) for u, w in zip(lx, ly))
    return {"params": equal(a.params, b.params),
            "m": equal(a.opt["m"], b.opt["m"]),
            "v": equal(a.opt["v"], b.opt["v"]),
            "count": equal(a.opt["count"], b.opt["count"]),
            "step": equal(a.step, b.step)}


def run_train_path(torch, kernels, params, calib, db, fam):
    """Phase 8: finetune the top member, stop and resume it bit for bit,
    shrink it, rebuild its database, and run the training CLI."""
    import shutil
    import tempfile

    import numpy as np
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import GPT2_SMALL
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.database import apply_assignment, build_database
    from repro_torch.core.hessian import collect_hessians
    from repro_torch.core.pipeline import masks_from_assignment
    from repro_torch.core.shrink import shrink_from_stitched
    from repro_torch.data import synthetic_stream
    from repro_torch.models import forward
    from repro_torch.models.pruned import forward_pruned
    from repro_torch.train import Trainer

    cfg = GPT2_SMALL.replace(num_layers=MAIN_LAYERS)
    steps = TRAIN_KW["total_steps"]
    target = MAIN_TARGETS[-1]
    a = fam[target].assignment
    student = apply_assignment(cfg, params, db, a)
    masks = masks_from_assignment(cfg, student, db, a)
    tcfg = TrainConfig(**TRAIN_KW)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")

    def trainer(name):
        return Trainer(cfg, tcfg, ckpt_dir=os.path.join(tmp, name),
                       teacher_params=params, masks=masks,
                       ckpt_every=TRAIN_EVERY, keep=2, log_every=1,
                       device="cuda")

    def stream(start=0):
        return synthetic_stream(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0,
                                start_step=start)

    try:
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ta = trainer("a")
        sa = ta.fit(ta.init_or_restore(student), stream(), steps=steps)
        ta.ckpt.close()
        torch.cuda.synchronize()
        run_a_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        log = ta.metrics_log
        step_ms = float(np.median(ta.watchdog.times[2:])) * 1e3
        tokens_s = TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3)
        print(f"train: {cfg.name} {target}x member ("
              f"{sum(a.values())} structures removed) against the dense "
              f"teacher, {TRAIN_KW}, batches {TRAIN_BATCH} x {TRAIN_SEQ}")
        print(f"train: run A {steps} steps in {run_a_s:.3f} s (checkpoints "
              f"at {TRAIN_EVERY} and {steps} included); median step "
              f"{step_ms:.3f} ms (steps 3-{steps}), "
              f"{tokens_s:.1f} training tokens/s, peak device memory "
              f"{peak:.2f} GiB")
        print("train: loss by step " + json.dumps(
            [round(m["loss"], 5) for m in log]))
        print(f"train: step 1 task_loss {log[0]['task_loss']:.5f} logit_kl "
              f"{log[0]['logit_kl']:.5f} token_l2 {log[0]['token_l2']:.5f}; "
              f"step {steps} task_loss {log[-1]['task_loss']:.5f} logit_kl "
              f"{log[-1]['logit_kl']:.5f} token_l2 {log[-1]['token_l2']:.5f}")
        check(len(log) == steps
              and all(math.isfinite(m["loss"]) for m in log),
              "run A: a loss is missing or not finite")
        check(log[0]["logit_kl"] > 0 and log[0]["token_l2"] > 0,
              "run A: a distillation term is 0 at step 1")
        check(rows_zero(torch, sa.params, db, a),
              "run A: a masked row is not 0")

        tb = trainer("b")
        sb = tb.fit(tb.init_or_restore(student), stream(), steps=steps,
                    stop_after=TRAIN_STOP)
        check(int(sb.step) == TRAIN_STOP
              and tb.ckpt.latest_step() == TRAIN_EVERY,
              f"run B stopped at {int(sb.step)}, checkpoint "
              f"{tb.ckpt.latest_step()}")
        tb.ckpt.close()
        del sb
        tc = trainer("b")
        sc = tc.init_or_restore(student)
        check(int(sc.step) == TRAIN_EVERY, f"run B resumed at {int(sc.step)}")
        check(rows_zero(torch, sc.params, db, a),
              "a masked row is not 0 in the restored checkpoint")
        sc = tc.fit(sc, stream(TRAIN_EVERY), steps=steps)
        tc.ckpt.close()
        same = _same_state(torch, sa, sc)
        print(f"train: run B stopped at {TRAIN_STOP}, resumed from step "
              f"{TRAIN_EVERY} by a new trainer to {steps}: bit-equal to run "
              f"A {same}")
        check(all(same.values()), f"resumed run differs from run A: {same}")
        del sc
        for d in ("a", "b"):
            shutil.rmtree(os.path.join(tmp, d))

        mgr = CheckpointManager(os.path.join(tmp, "t"), keep=1)
        t0 = time.perf_counter()
        mgr.save(steps, sa)
        t1 = time.perf_counter()
        mgr.wait()
        t2 = time.perf_counter()
        restored = mgr.restore(sa, steps)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        ck_dir = os.path.join(tmp, "t")
        nbytes = sum(os.path.getsize(os.path.join(ck_dir, f))
                     for f in os.listdir(ck_dir) if f.endswith(".npz"))
        print(f"checkpoint: {nbytes} bytes (params, m, v fp32); save: host "
              f"copy {t1 - t0:.3f} s + async write {t2 - t1:.3f} s; restore "
              f"{t3 - t2:.3f} s")
        check(all(_same_state(torch, sa, restored).values()),
              "a checkpoint does not restore to its state")
        mgr.close()
        del restored

        tokens = calib[0]["tokens"].cuda()
        with torch.no_grad():
            want = forward(cfg, sa.params, tokens)["logits"]
            got = forward_pruned(shrink_from_stitched(cfg, sa.params, db, a),
                                 tokens)
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        finite = bool(torch.isfinite(got).all())
        print(f"train: finetuned {target}x member shrunk vs masked "
              f"logits max_abs_err={err:.4e} (scale {scale:.4e}, tol "
              f"{STITCHED_TOL:g}*scale), finite {finite}")
        check(finite and err <= STITCHED_TOL * scale,
              "the finetuned member's shrunk logits disagree")
        del want, got

        t0 = time.perf_counter()
        db2 = build_database(cfg, sa.params,
                             collect_hessians(cfg, sa.params, calib,
                                              device="cuda"), device="cuda")
        torch.cuda.synchronize()
        rebuild_s = time.perf_counter() - t0
        launches = {k.__name__: k.launches for k in kernels.KERNELS}
        first, zero_err = [], []
        for name, removed in a.items():
            new, old = db2[name], db[name]
            first.append(set(new.order[:removed].tolist())
                         == set(old.order[:removed].tolist()))
            i = int(np.searchsorted(new.levels, removed))
            zero_err.append(bool(new.levels[i] == removed)
                            and float(new.errors[i]) == 0.0)
        print(f"train: Hessians and database rebuilt on the finetuned member "
              f"in {rebuild_s:.3f} s; the removed structures come first in "
              f"{sum(first)}/{len(first)} modules, at error 0 in "
              f"{sum(zero_err)}/{len(zero_err)}; launches {launches}")
        check(all(first), "a rebuilt order does not start with the removed "
              "structures")
        check(all(zero_err), "the rebuilt database's error at the member's "
              "level is not 0")
        for name in ONESHOT_KERNELS:
            check(launches[name] > 0, f"{name} never launched on phase 8")
        del db2

        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", *TRAIN_CLI,
             "--ckpt-dir", os.path.join(tmp, "cli")],
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=SRC),
            capture_output=True, text=True, timeout=300)
        print(f"train CLI: python -m repro_torch.launch.train "
              f"{' '.join(TRAIN_CLI)}: exit {out.returncode} in "
              f"{time.perf_counter() - t0:.2f} s")
        for line in (out.stdout + out.stderr).strip().splitlines()[-4:]:
            print(f"  {line}")
        check(out.returncode == 0, "the training CLI failed")
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# phase 9: the gradual family engine (core/pipeline.py gradual_prune) on
# the first FAMILY_LAYERS layers of phase 4's dense GPT-2 small and its
# calibration batches: targets 1.3x and 1.5x,
# each pruned, finetuned 16 steps of 8 x 512 with the reference's gradual
# defaults (lr 8e-5, 5 warm-up steps, logit 1.0 and token 0.5
# distillation), checkpointed at step 8 and exported on a background
# thread. Run A goes through; run B is killed after target 0's search and
# at step 12 of target 1's finetune, then resumed to the end, and must
# equal run A bit for bit. Both runs pass keep_checkpoints=False: no
# checkpoint at a finetune's last step (no run reads it; it was 2 of a
# run's 4 checkpoint writes until the script outgrew its time with phase
# 15), and each target's removed once its finetune has returned
FAMILY_TARGETS = [1.3, 1.5]
FAMILY_KW = {"finetune_steps": 16, "ckpt_every": 8, "search_steps": 16,
             "search_pop": 8}
FAMILY_TRAIN = {"learning_rate": 8e-5, "warmup_steps": 5, "total_steps": 16,
                "distill_logit": 1.0, "distill_token": 0.5}
FAMILY_BATCH, FAMILY_SEQ = 8, 512
FAMILY_STOP = 12
# the family prices with the cost model, whose table is the same in every
# build, so a resumed run searches its remaining targets against the
# killed run's table (a measured table differs from build to build). The
# hardware is runtime.costmodel.H100_SXM: the H100 SXM data sheet's rates
# above and 80 GB of memory; its 5e-6 s a module, a floor for an eager
# launch, is an assumption, not a measurement. The speedups it gives are
# the model's, not measured ones
FAMILY_ENV = {"batch": 16, "seq": 128, "mode": "prefill"}
# the family runs the first 2 of phase 4's 6 layers: the cost model's
# ceiling is 1.73x there (2.27x at 4 layers, 2.70x at 6), so 1.5x lies
# at 0.87 of it. It ran all 6 (88.66 s, two thirds of it the per-layer
# database, finetune and artifacts of runs A and B) until phase 15 took
# the script to 1155 s, then 4 with targets 1.5x and 2x (52.21 s) until
# phase 18's mesh trainer and family needed the time
FAMILY_LAYERS = 2
ARTIFACT_KINDS = ("hessians.npz", "db.npz", "params.npz", "ckpt",
                  "family.json")


def _artifact_bytes(run_dir: str) -> dict:
    """Bytes on disk under ``run_dir`` by artifact kind (trainer
    checkpoints under ``ckpt``)."""
    out = {k: 0 for k in ARTIFACT_KINDS}
    for d, _, files in os.walk(run_dir):
        for f in files:
            kind = "ckpt" if os.path.basename(d) == "ckpt" else f
            if kind in out:
                out[kind] += os.path.getsize(os.path.join(d, f))
    return out


def run_family_path(torch, kernels, params, calib):
    """Phase 9: gradual_prune on full-width GPT-2 small, run through and
    killed and resumed bit for bit."""
    import shutil
    import tempfile
    from types import SimpleNamespace

    import numpy as np
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.manager import load_json
    from repro_torch.configs import GPT2_SMALL
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.pipeline import (FamilyPreempted, family_run_dir,
                                           gradual_prune)
    from repro_torch.core.structures import registry
    from repro_torch.data import synthetic_stream
    from repro_torch.models import forward
    from repro_torch.models.pruned import forward_pruned
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.runtime.costmodel import H100_SXM, InferenceEnv

    cfg = GPT2_SMALL.replace(num_layers=FAMILY_LAYERS)
    params = {**params, "layers": {
        grp: {k: t[:FAMILY_LAYERS] for k, t in sub.items()}
        for grp, sub in params["layers"].items()}}
    env = InferenceEnv(hw=H100_SXM, **FAMILY_ENV)
    tcfg = TrainConfig(**FAMILY_TRAIN)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_family_")
    mods = {m.name: m for m in registry(cfg)}

    def data(step):
        return synthetic_stream(cfg, FAMILY_BATCH, FAMILY_SEQ, seed=0,
                                start_step=step)

    def run(name, **kw):
        return gradual_prune(cfg, params, env, FAMILY_TARGETS, data, calib,
                             tcfg=tcfg, ckpt_dir=os.path.join(tmp, name),
                             seed=0, keep_checkpoints=False, device="cuda",
                             **FAMILY_KW, **kw)

    def run_dir(name):
        return family_run_dir(cfg, FAMILY_TARGETS, 0, os.path.join(tmp, name))

    def preempted(name, stop):
        t0 = time.perf_counter()
        try:
            run(name, stop_after=stop)
        except FamilyPreempted as e:
            print(f"family: run {name} stopped at {stop} in "
                  f"{time.perf_counter() - t0:.3f} s ({e})")
            return
        check(False, f"run {name} was not preempted at {stop}")

    try:
        print(f"family: {cfg.name} targets {FAMILY_TARGETS}, {FAMILY_KW}, "
              f"{FAMILY_TRAIN}, batches {FAMILY_BATCH} x {FAMILY_SEQ}, "
              f"cost-model env {FAMILY_ENV} on {H100_SXM}; disk free "
              f"{shutil.disk_usage(tmp).free} B")
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        fam_a = run("a")
        torch.cuda.synchronize()
        run_a_s = time.perf_counter() - t0
        launches = {k.__name__: k.launches for k in kernels.KERNELS}
        peak = torch.cuda.max_memory_allocated() / 2**30
        man_a = load_json(os.path.join(run_dir("a"), "family.json"))
        print(f"family: run A {run_a_s:.3f} s, peak device memory "
              f"{peak:.2f} GiB, launches {launches}")
        print("family: run A bytes by artifact kind "
              + json.dumps(_artifact_bytes(run_dir("a"))))
        for t, v in zip(FAMILY_TARGETS, fam_a):
            e = man_a["targets"][f"{t:g}"]
            print(f"  target {t}x: achieved {v.achieved:.4f}x (cost "
                  f"model), structures removed {sum(v.assignment.values())}"
                  f", loss {v.loss_before_ft:.5f} -> {v.loss_after_ft:.5f}"
                  f", shrunk params {v.pruned.num_params()}; stage seconds "
                  + json.dumps({k: round(s, 4) for k, s in
                                e["stage_times"].items()}))
        shutil.rmtree(os.path.join(tmp, "a"))

        t0 = time.perf_counter()
        preempted("b", (0, "search"))
        preempted("b", (1, "finetune", FAMILY_STOP))
        last_t = f"{FAMILY_TARGETS[-1]:g}"
        ck = CheckpointManager(os.path.join(run_dir("b"), f"t{last_t}",
                                            "ckpt"), async_save=False)
        latest = ck.latest_step()
        ck.close()
        check(latest == FAMILY_KW["ckpt_every"],
              f"run B's killed finetune left checkpoint {latest}")
        t1 = time.perf_counter()
        fam_b = run("b")
        torch.cuda.synchronize()
        run_b_s = time.perf_counter() - t0
        man_b = load_json(os.path.join(run_dir("b"), "family.json"))
        last = [(e["target"], e["stage"]) for e in man_b["executed"]
                if e["run"] == man_b["runs"]]
        print(f"family: run B (two kills and the resume) {run_b_s:.3f} s, "
              f"the resume {time.perf_counter() - t1:.3f} s; it executed "
              f"{last}; bytes by artifact kind "
              + json.dumps(_artifact_bytes(run_dir("b"))))
        check(last == [(last_t, "finetune")],
              f"the last resume executed {last}, not target {last_t}'s "
              "finetune")
        for t in FAMILY_TARGETS:
            print(f"  target {t}x resumed: stage seconds " + json.dumps(
                {k: round(s, 4) for k, s in
                 man_b["targets"][f"{t:g}"]["stage_times"].items()}))

        speedups = []
        tokens = calib[0]["tokens"].cuda()
        for t, va, vb in zip(FAMILY_TARGETS, fam_a, fam_b):
            la, lb = tree_leaves(va.params), tree_leaves(vb.params)
            same = {"assignment": va.assignment == vb.assignment,
                    "achieved": va.achieved == vb.achieved,
                    "loss_before_ft": va.loss_before_ft == vb.loss_before_ft,
                    "loss_after_ft": va.loss_after_ft == vb.loss_after_ft,
                    "params": len(la) == len(lb) and all(
                        x.dtype == y.dtype and torch.equal(x, y)
                        for x, y in zip(la, lb))}
            print(f"  target {t}x: run B equals run A {same}")
            check(all(same.values()), f"{t}x: run B differs from run A")
            check(va.achieved >= t, f"{t}x not met: {va.achieved:.4f}x")
            speedups.append(va.achieved)
            with np.load(os.path.join(run_dir("b"), f"t{t:g}",
                                      "db.npz")) as f:
                orders = {n: SimpleNamespace(mod=mods[n],
                                             order=f[f"{n}::order"])
                          for n in va.assignment}
            check(rows_zero(torch, va.params, orders, va.assignment),
                  f"{t}x: a masked row is not 0")
            with torch.no_grad():
                want = forward(cfg, va.params, tokens)["logits"]
                got = forward_pruned(va.pruned, tokens)
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            finite = bool(torch.isfinite(got).all())
            print(f"  target {t}x: shrunk vs masked logits max_abs_err="
                  f"{err:.4e} (scale {scale:.4e}, tol {STITCHED_TOL:g}*"
                  f"scale), finite {finite}")
            check(finite and err <= STITCHED_TOL * scale,
                  f"{t}x: the shrunk member's logits disagree")
            del want, got
        print(f"family: speedups {speedups} (cost model)")
        check(all(a < b for a, b in zip(speedups, speedups[1:])),
              f"the family's speedups do not rise: {speedups}")
        for name in ONESHOT_KERNELS:
            check(launches[name] > 0, f"{name} never launched on phase 9")
        del fam_a, fam_b
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# phase 6: Mamba-2 2.7B at full width with 6 of its 64 layers. Each layer's
# database keeps 81 fp16 snapshots of its 5120 x 2560 out_proj (2.12 GB),
# all resident on the card in the SnapshotCache: 64 layers (136 GB) would
# not fit, 8 (17.0 GB) do. With phase 15 added the script took 1155 s, so
# 6 (not 8): the measured table's 0.666 ms logits head and 0.150 ms a
# layer (8 layers: 1.8632 ms, NVIDIA H100 80GB HBM3, 700 W) put the
# ceiling near 2.35x, the 2x target at 0.85 of it (at 4 layers, 1.9x, 2x
# is out of reach)
SSM_LAYERS = 6
# with 8 layers the unprunable logits head (2048 x 2560 x 50280) is about
# a third of the dense runtime, so a member can be at most about 2.6x
# faster than the dense model by operation count: 3x is out of reach
SSM_TARGETS = [1.25, 1.5, 2.0]
# the dense model generates SSM_GEN tokens from 2 prompts of SSM_PROMPT
SSM_PROMPT, SSM_GEN = 512, 8


def run_ssm_path(torch, kernels):
    """Phase 6: oneshot_prune on Mamba-2 2.7B, shrink, and generate."""
    from repro_torch.configs import MAMBA2_2P7B
    from repro_torch.core.database import apply_assignment
    from repro_torch.core.oneshot import oneshot_prune
    from repro_torch.core.shrink import shrink, shrink_from_stitched
    from repro_torch.data import calibration_batches
    from repro_torch.models import (forward, generate, model_init,
                                    serve_prefill, serve_step)
    from repro_torch.models.pruned import forward_pruned
    from repro_torch.runtime.costmodel import InferenceEnv

    cfg = MAMBA2_2P7B.replace(num_layers=SSM_LAYERS)
    t0 = time.perf_counter()
    params = model_init(cfg, torch.Generator().manual_seed(0), device="cuda")
    calib = calibration_batches(cfg, 32, 512, batch=8)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    env = InferenceEnv(batch=16, seq=128, mode="prefill", hw=None)

    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = oneshot_prune(cfg, params, calib, env, SSM_TARGETS,
                        latency_backend="measure", latency_kw=LATENCY_KW,
                        search_steps=48, search_pop=16, seed=0,
                        device="cuda")
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels.KERNELS}
    snap_bytes = sum(m.snapshots.nbytes for m in res.db.values())

    print(f"Mamba-2 path: {cfg.name} layers={cfg.num_layers} of "
          f"{MAMBA2_2P7B.num_layers} d_model={cfg.d_model} "
          f"d_inner={cfg.d_inner} heads={cfg.ssm_heads}x{cfg.ssm_head_dim} "
          f"state={cfg.ssm_state} chunk={cfg.ssm_chunk} "
          f"vocab={cfg.vocab_size} dtype={cfg.dtype}; calibration 32 x 512 "
          f"tokens in batches of 8; env batch={env.batch} seq={env.seq} "
          f"{env.mode}, measured table ({LATENCY_KW}); targets {SSM_TARGETS}")
    print(f"Mamba-2 path: setup (weights + tokens) {setup_s:.3f} s, "
          f"oneshot_prune {total_s:.3f} s, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, database "
          f"snapshots {snap_bytes} bytes ({snap_bytes / cfg.num_layers / 1e9:.2f}"
          f" GB a layer)")
    print("Mamba-2 stage seconds: " + json.dumps(
        {k: round(v, 4) for k, v in res.stage_seconds.items()}))
    print(f"Mamba-2 path launches: {launches}")
    print(f"Mamba-2 dense: table runtime {res.dense_runtime * 1e3:.4f} ms "
          f"(logits head {res.table.base * 1e3:.4f} ms), calibration loss "
          f"{res.dense_loss:.4f}")
    for t in SSM_TARGETS:
        v = res.variants[t]
        print(f"  target {t}x: speedup {v.speedup:.3f}x, runtime "
              f"{v.runtime * 1e3:.4f} ms, loss {v.calib_loss:.4f}, heads "
              f"removed {sum(v.assignment.values())}, evals "
              f"{v.search.n_evals}")
        check(v.speedup >= t, f"Mamba-2 target {t}x not met: {v.speedup:.4f}x")
        check(math.isfinite(v.calib_loss), f"Mamba-2 {t}x: non-finite loss")
        w = v.params["layers"]["ssm"]["out_proj"]
        check(w.shape == params["layers"]["ssm"]["out_proj"].shape
              and bool(torch.isfinite(w).all()),
              f"Mamba-2 {t}x: out_proj has the wrong shape or non-finite "
              "values")
    check(math.isfinite(res.dense_loss), "Mamba-2: non-finite dense loss")
    for name in SSM_KERNELS:
        check(launches[name] > 0, f"{name} never launched on the Mamba-2 path")
    fam = check_prior_family(torch, cfg, params, calib, res, SSM_TARGETS)

    tokens = calib[0]["tokens"].cuda()
    with torch.no_grad():
        for t in SSM_TARGETS:
            a = fam[t].assignment
            stitched = apply_assignment(cfg, params, res.db, a)
            host_pm = shrink(cfg, params, res.db, a, device="cuda")
            dev_pm = shrink_from_stitched(cfg, stitched, res.db, a)
            hl, dl = (_leaves([l.params for l in pm.layers] + [pm.globals_])
                      for pm in (host_pm, dev_pm))
            same = len(hl) == len(dl) and all(
                x.dtype == y.dtype and torch.equal(x, y)
                for x, y in zip(hl, dl)) and [
                l.ssm_heads for l in host_pm.layers] == [
                l.ssm_heads for l in dev_pm.layers]
            want = forward(cfg, stitched, tokens)["logits"]
            got = forward_pruned(host_pm, tokens)
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            finite = bool(torch.isfinite(got).all())
            print(f"  prior-scored {t}x shrunk: SSD heads per layer "
                  f"{[l.ssm_heads for l in host_pm.layers]}, params "
                  f"{host_pm.num_params()}, shrink_from_stitched == shrink "
                  f"({len(hl)} leaves bit-equal): {same}; logits vs stitched "
                  f"on {tuple(tokens.shape)} tokens max_abs_err={err:.4e} "
                  f"(scale {scale:.4e}, tol {STITCHED_TOL:g}*scale), finite "
                  f"{finite}")
            check(same, f"Mamba-2 {t}x: shrink_from_stitched differs from "
                  "shrink")
            check(finite and err <= STITCHED_TOL * scale,
                  f"Mamba-2 {t}x: shrunk logits disagree with the stitched "
                  "model")
            del stitched, host_pm, dev_pm, want, got

        prompt = tokens[:2, :SSM_PROMPT]
        t0 = time.perf_counter()
        logits, cache = serve_prefill(cfg, params, {"tokens": prompt},
                                      max_len=SSM_PROMPT + SSM_GEN)
        finite = bool(torch.isfinite(logits).all())
        toks = [logits.argmax(-1)]
        for _ in range(SSM_GEN - 1):
            logits, cache = serve_step(cfg, params, cache, toks[-1])
            finite = finite and bool(torch.isfinite(logits).all())
            toks.append(logits.argmax(-1))
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        out = generate(cfg, params, prompt, SSM_GEN)
    print(f"Mamba-2 generate: {tuple(prompt.shape)} prompts, {SSM_GEN} "
          f"tokens in {gen_s:.3f} s (prefill + recurrent decode), logits "
          f"finite {finite}, tokens {out.tolist()}")
    check(finite, "Mamba-2 generate: non-finite logits")
    check(torch.equal(out, torch.cat(toks, dim=1)),
          "Mamba-2 generate differs from its prefill and decode steps")
    return launches


# phase 10: gradual ZipLM (core/pipeline.py gradual_prune) on Mamba-2 2.7B
# at full width with 1 of its 64 layers and seeded weights: every train
# step runs the SSD forward and backward kernels. A layer's database holds
# 2.12 GB of snapshots on the card and each target writes them all to its
# db.npz, so the depth is cut to 1 (2 until the script outgrew its time).
# At 1 layer the unprunable logits head is 0.7271 of the cost model's
# dense runtime (a 1.3753x ceiling), so targets 1.15x and 1.3x (the table's
# split is printed first). Phase 9's gradual defaults, search and
# cost-model table; 8 finetune steps a target, a checkpoint at step 4
# (keep_checkpoints=False as in phase 9: the one at step 8 is not
# written). Run B is killed at step 4 of target 1's finetune and resumed,
# and must equal run A bit for bit
SSM_FAMILY_LAYERS = 1
SSM_FAMILY_TARGETS = [1.15, 1.3]
SSM_FAMILY_KW = {"finetune_steps": 8, "ckpt_every": 4, "search_steps": 16,
                 "search_pop": 8}
SSM_FAMILY_STOP = 4
# train steps timed apart, the first two untimed
SSM_FAMILY_TIMED = 6
SSM_FAMILY_KERNELS = ("ssd_intra_chunk", "ssd_intra_chunk_backward",
                      "hessian_accum", "obs_downdate")


def time_ssm_train_steps(torch, kernels, cfg, tcfg, student, teacher):
    """(median ms, backward launches a step) of SSM_FAMILY_TIMED train
    steps of ``student`` against ``teacher`` on FAMILY_BATCH x FAMILY_SEQ
    tokens, each ended by a synchronize; the median of all but the first
    two."""
    import numpy as np
    from repro_torch.data import synthetic_stream
    from repro_torch.train import make_train_state, make_train_step
    step = make_train_step(cfg, tcfg, teacher_params=teacher, device="cuda")
    state = make_train_state(cfg, student, tcfg)
    data = synthetic_stream(cfg, FAMILY_BATCH, FAMILY_SEQ, seed=1)
    before = kernels.ssd_intra_chunk_backward.launches
    times = []
    for _ in range(SSM_FAMILY_TIMED):
        batch = next(data)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        check(math.isfinite(loss), "Mamba-2 train step: non-finite loss")
    launched = kernels.ssd_intra_chunk_backward.launches - before
    del state, step
    return (float(np.median(times[2:])) * 1e3,
            launched / SSM_FAMILY_TIMED)


def run_ssm_family_path(torch, kernels):
    """Phase 10: gradual_prune on full-width Mamba-2 2.7B at 1 layer, run
    through, killed mid-finetune and resumed bit for bit."""
    import shutil
    import tempfile
    from types import SimpleNamespace

    import numpy as np
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.manager import load_json
    from repro_torch.configs import MAMBA2_2P7B
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.latency import build_table
    from repro_torch.core.pipeline import (FamilyPreempted, family_run_dir,
                                           gradual_prune)
    from repro_torch.core.shrink import layer_drop_plan
    from repro_torch.core.structures import registry
    from repro_torch.data import calibration_batches, synthetic_stream
    from repro_torch.models import forward, model_init
    from repro_torch.models.pruned import forward_pruned
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.runtime.costmodel import H100_SXM, InferenceEnv

    cfg = MAMBA2_2P7B.replace(num_layers=SSM_FAMILY_LAYERS)
    targets = SSM_FAMILY_TARGETS
    env = InferenceEnv(hw=H100_SXM, **FAMILY_ENV)
    tcfg = TrainConfig(**{**FAMILY_TRAIN,
                          "total_steps": SSM_FAMILY_KW["finetune_steps"]})
    t0 = time.perf_counter()
    params = model_init(cfg, torch.Generator().manual_seed(0), device="cuda")
    calib = calibration_batches(cfg, 32, 512, batch=8)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    mods = registry(cfg)
    by_name = {m.name: m for m in mods}
    table = build_table(cfg, env, "costmodel", device="cuda")
    dense = table.dense_runtime(mods)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ssm_family_")

    def data(step):
        return synthetic_stream(cfg, FAMILY_BATCH, FAMILY_SEQ, seed=0,
                                start_step=step)

    def run(name, **kw):
        return gradual_prune(cfg, params, env, targets, data, calib,
                             tcfg=tcfg, ckpt_dir=os.path.join(tmp, name),
                             seed=0, keep_checkpoints=False, device="cuda",
                             **SSM_FAMILY_KW, **kw)

    def run_dir(name):
        return family_run_dir(cfg, targets, 0, os.path.join(tmp, name))

    try:
        print(f"SSM family: {cfg.name} layers={cfg.num_layers} of "
              f"{MAMBA2_2P7B.num_layers} d_model={cfg.d_model} heads="
              f"{cfg.ssm_heads}x{cfg.ssm_head_dim} state={cfg.ssm_state} "
              f"chunk={cfg.ssm_chunk} vocab={cfg.vocab_size} dtype="
              f"{cfg.dtype}; targets {targets}, {SSM_FAMILY_KW}, {tcfg}, "
              f"batches {FAMILY_BATCH} x {FAMILY_SEQ}, calibration 32 x 512 "
              f"in batches of 8, cost-model env {FAMILY_ENV} on "
              f"{H100_SXM}; setup {setup_s:.3f} s; disk free "
              f"{shutil.disk_usage(tmp).free} B")
        print(f"SSM family: cost-model dense runtime {dense * 1e3:.6f} ms, "
              f"of which the logits head {table.base * 1e3:.6f} ms "
              f"({table.base / dense:.4f}) and the {len(mods)} SSD layers "
              f"{(dense - table.base) * 1e3:.6f} ms: a member is at most "
              f"{dense / table.base:.4f}x faster")
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        fam_a = run("a")
        torch.cuda.synchronize()
        run_a_s = time.perf_counter() - t0
        launches = {k.__name__: k.launches for k in kernels.KERNELS}
        peak = torch.cuda.max_memory_allocated() / 2**30
        man_a = load_json(os.path.join(run_dir("a"), "family.json"))
        print(f"SSM family: run A {run_a_s:.3f} s, peak device memory "
              f"{peak:.2f} GiB, launches {launches}")
        print("SSM family: run A bytes by artifact kind "
              + json.dumps(_artifact_bytes(run_dir("a"))))
        for t, v in zip(targets, fam_a):
            e = man_a["targets"][f"{t:g}"]
            print(f"  target {t}x: achieved {v.achieved:.4f}x (cost model)"
                  f", heads removed {v.assignment}, layers dropped "
                  f"{sum(layer_drop_plan(cfg, v.assignment))}, loss "
                  f"{v.loss_before_ft:.5f} -> {v.loss_after_ft:.5f}, "
                  f"shrunk params {v.pruned.num_params()}; stage seconds "
                  + json.dumps({k: round(s, 4) for k, s in
                                e["stage_times"].items()}))
        shutil.rmtree(os.path.join(tmp, "a"))

        step_ms, per_step = time_ssm_train_steps(
            torch, kernels, cfg, tcfg, fam_a[0].params, params)
        tokens = FAMILY_BATCH * FAMILY_SEQ
        print(f"SSM family: a train step of the {targets[0]}x member "
              f"against the dense teacher, {FAMILY_BATCH} x {FAMILY_SEQ} "
              f"tokens: {step_ms:.3f} ms (median of steps 3-"
              f"{SSM_FAMILY_TIMED}), {tokens / step_ms * 1e3:.1f} training "
              f"tokens/s, {per_step:g} SSD backward launches a step")
        check(per_step == cfg.num_layers,
              "the SSD backward kernel did not launch once a layer a step")

        t0 = time.perf_counter()
        stop = (1, "finetune", SSM_FAMILY_STOP)
        try:
            run("b", stop_after=stop)
            check(False, f"run B was not preempted at {stop}")
        except FamilyPreempted as e:
            print(f"SSM family: run B stopped at {stop} in "
                  f"{time.perf_counter() - t0:.3f} s ({e})")
        ck = CheckpointManager(os.path.join(run_dir("b"), f"t{targets[1]:g}",
                                            "ckpt"), async_save=False)
        latest = ck.latest_step()
        ck.close()
        check(latest == SSM_FAMILY_STOP,
              f"run B's killed finetune left checkpoint {latest}")
        t1 = time.perf_counter()
        fam_b = run("b")
        torch.cuda.synchronize()
        run_b_s = time.perf_counter() - t0
        man_b = load_json(os.path.join(run_dir("b"), "family.json"))
        last = [(e["target"], e["stage"]) for e in man_b["executed"]
                if e["run"] == man_b["runs"]]
        print(f"SSM family: run B (the kill and the resume) {run_b_s:.3f} "
              f"s, the resume {time.perf_counter() - t1:.3f} s; it executed "
              f"{last}; bytes by artifact kind "
              + json.dumps(_artifact_bytes(run_dir("b"))))
        check(last == [(f"{targets[1]:g}", "finetune")],
              f"the resume executed {last}, not target 2's finetune")

        tokens = calib[0]["tokens"].cuda()
        for t, va, vb in zip(targets, fam_a, fam_b):
            la, lb = tree_leaves(va.params), tree_leaves(vb.params)
            same = {"assignment": va.assignment == vb.assignment,
                    "achieved": va.achieved == vb.achieved,
                    "loss_before_ft": va.loss_before_ft == vb.loss_before_ft,
                    "loss_after_ft": va.loss_after_ft == vb.loss_after_ft,
                    "params": len(la) == len(lb) and all(
                        x.dtype == y.dtype and torch.equal(x, y)
                        for x, y in zip(la, lb))}
            print(f"  target {t}x: run B equals run A {same}")
            check(all(same.values()), f"{t}x: run B differs from run A")
            check(va.achieved >= t, f"{t}x not met: {va.achieved:.4f}x")
            check(math.isfinite(va.loss_after_ft), f"{t}x: non-finite loss")
            with np.load(os.path.join(run_dir("b"), f"t{t:g}",
                                      "db.npz")) as f:
                orders = {n: SimpleNamespace(mod=by_name[n],
                                             order=f[f"{n}::order"])
                          for n in va.assignment}
            check(rows_zero(torch, va.params, orders, va.assignment),
                  f"{t}x: a masked row is not 0")
            with torch.no_grad():
                want = forward(cfg, va.params, tokens)["logits"]
                got = forward_pruned(va.pruned, tokens)
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            finite = bool(torch.isfinite(got).all())
            print(f"  target {t}x: SSD heads per layer "
                  f"{[l.ssm_heads for l in va.pruned.layers]}, shrunk vs "
                  f"masked logits max_abs_err={err:.4e} (scale "
                  f"{scale:.4e}, tol {STITCHED_TOL:g}*scale), finite "
                  f"{finite}")
            check(finite and err <= STITCHED_TOL * scale,
                  f"{t}x: the shrunk member's logits disagree")
            del want, got
        for name in SSM_FAMILY_KERNELS:
            check(launches[name] > 0, f"{name} never launched on phase 10")
        del fam_a, fam_b, params
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# phase 7: Phi-3.5-MoE at full width with 1 of its 32 layers. In width
# mode each of a layer's 16 experts keeps 44 fp16 snapshots of its
# 6400 x 4096 wd: 36.9 GB a layer, all on the card during the build, copied
# to host memory and uploaded whole again into the SnapshotCache. 2 layers
# (73.8 GB of snapshots) would not fit the card's 80 GB; 1 does. Expert
# mode keeps 2 snapshots an expert (1.68 GB a layer)
MOE_LAYERS = 1
# with 1 layer the unprunable logits head (2048 x 4096 x 32064) bounds
# every member's speedup, at a measured ceiling near 4.1x
MOE_TARGETS = [1.25, 1.5, 2.0]
# 8 requests a member (16 before phase 15 was added: 4.2 and 3.7 s of
# serving in width and expert mode)
MOE_SERVE = {"max_len": 576, "slots": 8, "requests": 8}
MOE_STREAM = {"seed": 0, "rate": 50.0, "prompt_lens": (128, 256, 384, 512),
              "steps_range": (16, 32)}
# the dense model's capacity factor while its logits are held against a
# shrunk member's (which never drops a token), as the reference's decode
# test lifts it
NO_DROPS = 8.0


def run_moe_path(torch, kernels):
    """Phase 7: one-shot ZipLM on Phi-3.5-MoE in both MoE prune modes,
    shrink, serve, generate. Returns the launch counts, and the dense
    params and calibration batches for phase 11."""
    from repro_torch.configs import PHI35_MOE
    from repro_torch.core import database
    from repro_torch.core.hessian import collect_hessians
    from repro_torch.data import calibration_batches
    from repro_torch.models import generate, model_init, serve_prefill, \
        serve_step
    from repro_torch.runtime.costmodel import InferenceEnv

    cfg = PHI35_MOE.replace(num_layers=MOE_LAYERS)
    t0 = time.perf_counter()
    params = model_init(cfg, torch.Generator().manual_seed(0), device="cuda")
    calib = calibration_batches(cfg, 32, 512, batch=8)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    env = InferenceEnv(batch=16, seq=128, mode="prefill", hw=None)
    targets = MOE_TARGETS
    print(f"MoE path: {cfg.name} layers={cfg.num_layers} of "
          f"{PHI35_MOE.num_layers} d_model={cfg.d_model} heads="
          f"{cfg.num_heads}:{cfg.num_kv_heads}x{cfg.resolved_head_dim} experts="
          f"{cfg.num_experts} top-{cfg.num_experts_per_tok} d_ff={cfg.d_ff} "
          f"vocab={cfg.vocab_size} dtype={cfg.dtype}; calibration 32 x 512 "
          f"tokens in batches of 8; env batch={env.batch} seq={env.seq} "
          f"{env.mode}, measured table ({LATENCY_KW}); targets {targets};"
          f" setup (weights + tokens) {setup_s:.3f} s")

    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    hess = collect_hessians(cfg, params, calib, device="cuda")
    torch.cuda.synchronize()
    print(f"MoE path: calibration (Hessians of {len(hess)} modules, reused "
          f"by both modes) {time.perf_counter() - t0:.3f} s")
    for mode in ("width", "expert"):
        t0 = time.perf_counter()
        run_moe_mode(torch, kernels, database,
                     cfg.replace(moe_prune_unit=mode), params, calib, env,
                     hess, targets)
        print(f"MoE path: {mode} mode done ({time.perf_counter() - t0:.2f} "
              "s)")
    del hess

    prompt = calib[0]["tokens"][:2, :SSM_PROMPT].cuda()
    with torch.no_grad():
        t0 = time.perf_counter()
        logits, cache = serve_prefill(cfg, params, {"tokens": prompt},
                                      max_len=SSM_PROMPT + SSM_GEN)
        finite = bool(torch.isfinite(logits).all())
        toks = [logits.argmax(-1)]
        for _ in range(SSM_GEN - 1):
            logits, cache = serve_step(cfg, params, cache, toks[-1])
            finite = finite and bool(torch.isfinite(logits).all())
            toks.append(logits.argmax(-1))
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        out = generate(cfg, params, prompt, SSM_GEN)
    launches = {k.__name__: k.launches for k in kernels.KERNELS}
    print(f"MoE generate: {tuple(prompt.shape)} prompts, {SSM_GEN} tokens in "
          f"{gen_s:.3f} s (prefill + decode), logits finite {finite}, tokens "
          f"{out.tolist()}")
    print(f"MoE path launches (calibration to generate, both modes): "
          f"{launches}")
    check(finite, "MoE generate: non-finite logits")
    check(torch.equal(out, torch.cat(toks, dim=1)),
          "MoE generate differs from its prefill and decode steps")
    for name in MOE_KERNELS:
        check(launches[name] > 0, f"{name} never launched on the MoE path")
    return launches, params, calib


def run_moe_mode(torch, kernels, database, cfg, params, calib, env, hess,
                 targets):
    """Phase 7, one MoE prune mode: oneshot_prune from the shared Hessians,
    every distinct member shrunk and held against its stitched model, the
    family served, engine tokens against per-request decoding."""
    from repro_torch.core.oneshot import oneshot_prune
    from repro_torch.core.shrink import shrink, shrink_from_stitched
    from repro_torch.models import forward, moe
    from repro_torch.models.pruned import forward_pruned, kv_cache_bytes
    from repro_torch.serve import (DENSE_TARGET, DenseServeModel,
                                   FamilyServer, PrunedServeModel,
                                   ServeEngine, synthetic_requests)

    mode = cfg.moe_prune_unit
    database.reset_snapshot_traffic()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = oneshot_prune(cfg, params, calib, env, targets,
                        latency_backend="measure", latency_kw=LATENCY_KW,
                        search_steps=48, search_pop=16, seed=0,
                        hessians=hess, device="cuda")
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    traffic = dict(database.SNAPSHOT_TRAFFIC)
    snap_bytes = sum(m.snapshots.nbytes for m in res.db.values())
    levels = {m.mod.kind: len(m.levels) for m in res.db.values()}
    print(f"MoE {mode}: oneshot_prune {total_s:.3f} s (calibration reused), "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB, {len(res.db)} modules, levels {levels}, database snapshots "
          f"{snap_bytes} bytes ({snap_bytes / cfg.num_layers / 1e9:.2f} GB a "
          f"layer); host round trip: fetch {traffic['fetch_bytes']} bytes in "
          f"{traffic['fetch_s']:.3f} s, upload {traffic['upload_bytes']} bytes"
          f" in {traffic['upload_s']:.3f} s")
    print(f"MoE {mode} stage seconds: " + json.dumps(
        {k: round(v, 4) for k, v in res.stage_seconds.items()}))
    print(f"MoE {mode} table: base {res.table.base * 1e3:.4f} ms, " + ", ".join(
        f"{k} levels {res.table.grids[k].tolist()} ms "
        f"{[round(float(x) * 1e3, 4) for x in res.table.times[k]]}"
        for k in res.table.grids))
    print(f"MoE {mode} dense: table runtime {res.dense_runtime * 1e3:.4f} ms "
          f"(unprunable base {res.table.base * 1e3:.4f} ms, so at most "
          f"{res.dense_runtime / res.table.base:.2f}x), calibration loss "
          f"{res.dense_loss:.4f}")
    check(math.isfinite(res.dense_loss), f"MoE {mode}: non-finite dense loss")
    for t in targets:
        v = res.variants[t]
        experts = [v.assignment[n] for n in sorted(v.assignment)
                   if ".expert" in n]
        print(f"  target {t}x: speedup {v.speedup:.3f}x, runtime "
              f"{v.runtime * 1e3:.4f} ms, loss {v.calib_loss:.4f}, attention "
              f"KV heads removed {v.assignment['L0.attn']}, experts dropped "
              f"{sum(e == cfg.d_ff for e in experts)}, expert rows removed "
              f"{sum(experts)}, evals {v.search.n_evals}")
        check(v.speedup >= t, f"MoE {mode} target {t}x not met: "
              f"{v.speedup:.4f}x")
        check(math.isfinite(v.calib_loss), f"MoE {mode} {t}x: non-finite loss")
        w = v.params["layers"]["moe"]["wd"]
        check(w.shape == params["layers"]["moe"]["wd"].shape
              and bool(torch.isfinite(w).all()),
              f"MoE {mode} {t}x: wd has the wrong shape or non-finite values")
    assignments = {t: v.assignment for t, v in res.variants.items()}
    distinct = {}
    for t, a in assignments.items():
        distinct.setdefault(tuple(sorted(a.items())), t)
    print(f"MoE {mode}: {len(distinct)} distinct member(s) for "
          f"{len(targets)} targets")

    # each distinct member: shrink == shrink_from_stitched, and its shrunk
    # logits against its stitched model's with no token dropped
    tokens = calib[0]["tokens"].cuda()
    old_cf = moe.CAPACITY_FACTOR
    with torch.no_grad():
        for t in distinct.values():
            a = assignments[t]
            stitched = res.variants[t].params
            t0 = time.perf_counter()
            host_pm = shrink(cfg, params, res.db, a, device="cuda")
            host_s = time.perf_counter() - t0
            dev_pm = shrink_from_stitched(cfg, stitched, res.db, a)
            hl, dl = (_leaves([l.params for l in pm.layers] + [pm.globals_])
                      for pm in (host_pm, dev_pm))
            same = len(hl) == len(dl) and all(
                (x is None and y is None) or (
                    x is not None and y is not None and x.dtype == y.dtype
                    and torch.equal(x, y)) for x, y in zip(hl, dl)) and [
                (l.kv_groups, l.expert_ff) for l in host_pm.layers] == [
                (l.kv_groups, l.expert_ff) for l in dev_pm.layers]
            moe.CAPACITY_FACTOR = NO_DROPS
            try:
                want = forward(cfg, stitched, tokens)["logits"]
            finally:
                moe.CAPACITY_FACTOR = old_cf
            got = forward_pruned(dev_pm, tokens)
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            finite = bool(torch.isfinite(got).all())
            print(f"  {t}x shrunk: KV heads {[l.kv_groups for l in dev_pm.layers]}"
                  f", expert widths {[l.expert_ff for l in dev_pm.layers]}, "
                  f"params {dev_pm.num_params()}, shrink ({host_s:.3f} s) == "
                  f"shrink_from_stitched ({len(hl)} leaves bit-equal): {same}; "
                  f"logits vs stitched (capacity factor {NO_DROPS}) on "
                  f"{tuple(tokens.shape)} tokens max_abs_err={err:.4e} (scale "
                  f"{scale:.4e}, tol {STITCHED_TOL:g}*scale), finite {finite}")
            check(same, f"MoE {mode} {t}x: shrink_from_stitched differs from "
                  "shrink")
            check(finite and err <= STITCHED_TOL * scale,
                  f"MoE {mode} {t}x: shrunk logits disagree with the stitched "
                  "model")
            del host_pm, dev_pm, want, got, hl, dl
    res.variants.clear()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    server = FamilyServer(cfg, params, res.db, assignments,
                          max_len=MOE_SERVE["max_len"],
                          num_slots=MOE_SERVE["slots"])
    server.warmup(MOE_STREAM["prompt_lens"])
    torch.cuda.synchronize()
    print(f"MoE {mode} serving: FamilyServer of {sorted(server.members)} "
          f"stood up and warmed in {time.perf_counter() - t0:.3f} s "
          f"({MOE_SERVE})")
    reqs = synthetic_requests(cfg, MOE_SERVE["requests"], **MOE_STREAM)
    t0 = time.perf_counter()
    flash0 = kernels.flash_attention.launches
    reports = {t: eng.run(reqs) for t, eng in sorted(server.members.items())}
    routed = server.run(reqs)
    torch.cuda.synchronize()
    print(f"MoE {mode} serving: {len(reqs)} requests through each of "
          f"{len(reports)} members, then routed, in "
          f"{time.perf_counter() - t0:.3f} s; flash_attention launches "
          f"{kernels.flash_attention.launches - flash0}")
    for t, rep in sorted(reports.items()):
        m = rep.as_dict()
        print(f"  member {t}x: KV bytes {m['kv_cache_bytes']}, prefill "
              f"{m['prefill_ms_mean']:.4f} ms (mean), decode "
              f"{m['decode_ms_per_token_mean']:.4f} ms/token, "
              f"{m['tokens_per_s']:.2f} tokens/s, p50 {m['p50_ms']:.3f} ms, "
              f"p99 {m['p99_ms']:.3f} ms, {m['total_tokens']} tokens in "
              f"{rep.steps} steps")
        if t != DENSE_TARGET:
            want_kv = kv_cache_bytes(server.members[t].model.pm,
                                     MOE_SERVE["slots"], MOE_SERVE["max_len"])
            check(m["kv_cache_bytes"] == want_kv,
                  f"MoE {mode} {t}x: KV bytes {m['kv_cache_bytes']} != "
                  f"{want_kv}")
    for t, rep in sorted(routed.items()):
        check(all(server.route(r.latency_class) == t for r in rep.records),
              f"MoE {mode}: routing sent a request to the wrong member {t}x")

    # engine tokens against per-request decoding in fp32, two requests per
    # member: a shrunk member never drops a token, so it must match; the
    # dense model's engine prefills at the padded bucket, whose larger
    # expert capacity can keep an assignment that the prompt alone drops
    # (ROADMAP Queue 3), so it must match with no drops and is reported
    # as served
    pick = reqs[:2]
    cfg32 = cfg.replace(dtype="float32")
    for t in sorted(server.members):
        if t == DENSE_TARGET:
            model32 = DenseServeModel(cfg32, params, MOE_SERVE["max_len"])
        else:
            a = assignments[t]
            model32 = PrunedServeModel(shrink_from_stitched(
                cfg32, server.snapshots.apply(params, a), res.db, a),
                MOE_SERVE["max_len"])
        served = [r.tokens for r in ServeEngine(
            model32, MOE_SERVE["slots"]).run(pick).records]
        alone = [_alone(torch, model32, r, MOE_SERVE["max_len"])
                 for r in pick]
        line = (f"  member {t}x: engine == per-request decoding (fp32) for "
                f"requests {[r.rid for r in pick]} (prompts "
                f"{[r.prompt_len for r in pick]}, {[r.steps for r in pick]} "
                f"tokens): {served == alone}")
        if t == DENSE_TARGET:
            moe.CAPACITY_FACTOR = NO_DROPS
            try:
                served_nd = [r.tokens for r in ServeEngine(
                    model32, MOE_SERVE["slots"]).run(pick).records]
                alone_nd = [_alone(torch, model32, r, MOE_SERVE["max_len"])
                            for r in pick]
            finally:
                moe.CAPACITY_FACTOR = old_cf
            print(line + f" as served; with capacity factor {NO_DROPS}: "
                  f"{served_nd == alone_nd}")
            check(served_nd == alone_nd, f"MoE {mode}: dense engine tokens "
                  "differ from per-request decoding with no drops")
        else:
            print(line)
            check(served == alone, f"MoE {mode} {t}x: engine tokens differ "
                  "from per-request decoding")
        del model32
    del server, res
    torch.cuda.empty_cache()


# phase 11: gradual ZipLM on phase 7's dense Phi-3.5-MoE (1 of 32 layers,
# the same seeded weights and calibration batches) in expert mode: each
# expert kept or dropped whole, KV groups with their query heads. Priced by
# the cost model on H100_SXM (FAMILY_ENV) as phases 9 and 10 are; 4
# finetune steps a target of FAMILY_BATCH x FAMILY_SEQ tokens with the
# engine's gradual defaults, SPDY 16 candidates in populations of 8, and
# the export beside the next target.
MOE_FAMILY_TARGETS = [1.3, 1.6]
MOE_FAMILY_KW = {"finetune_steps": 4, "ckpt_every": 4, "search_steps": 16,
                 "search_pop": 8}
MOE_FAMILY_KERNELS = ("hessian_accum",)
# a target wrote about 27.6 GB (its Hessians 2.69 GB, its database 1.98
# GB, its checkpoint of params, m and v 17.18 GB, its params 5.73 GB), and
# the card's machine caps what one call writes to its disk at 45 GiB, so
# the run passes keep_checkpoints=False. Since the script outgrew its time
# with phase 15, that flag also leaves out the checkpoint at a finetune's
# last step, here the only one (ckpt_every = finetune_steps): each target
# writes no checkpoint, about 10.4 GB in all
# the repeated train steps of the determinism check
MOE_REPEAT_STEPS = 2


def state_digest(torch, state, chunk: int = 1 << 24):
    """A digest of every bit of a train state's params, m and v: each
    leaf's fp32 words as integers, summed with two streams of seeded
    random 64-bit weights (wrapping), ``chunk`` words at a time. Two
    states with any differing word give different digests except with
    probability below 2^-33 (a linear hash over the integers mod 2^64),
    and a digest is small, so one state need not stay on the card beside
    the other."""
    from repro_torch.optim.adamw import tree_leaves
    out = []
    g = torch.Generator(device="cuda").manual_seed(0)
    for tree in (state.params, state.opt["m"], state.opt["v"]):
        for leaf in tree_leaves(tree):
            words = leaf.detach().contiguous().view(torch.int32).reshape(-1)
            acc = torch.zeros(2, dtype=torch.int64, device="cuda")
            for i in range(0, words.numel(), chunk):
                piece = words[i:i + chunk].to(torch.int64)
                w = torch.randint(-2**62, 2**62, (2, piece.numel()),
                                  generator=g, device="cuda")
                acc += (w * piece).sum(-1)
            out.append(acc)
    return torch.stack(out).cpu()


def run_moe_family_path(torch, kernels, params, calib):
    """Phase 11: gradual_prune on full-width Phi-3.5-MoE at 1 layer in
    expert mode, then two train steps repeated from one state."""
    import shutil
    import tempfile

    import numpy as np
    from repro_torch.checkpoint.manager import load_json
    from repro_torch.configs import PHI35_MOE
    from repro_torch.core.latency import build_table
    from repro_torch.core.pipeline import (family_run_dir, gradual_prune,
                                           gradual_train_config,
                                           masks_from_assignment)
    from repro_torch.core.structures import registry
    from repro_torch.data import synthetic_stream
    from repro_torch.models import forward, moe
    from repro_torch.models.pruned import forward_pruned
    from repro_torch.runtime.costmodel import H100_SXM, InferenceEnv
    from repro_torch.train import make_train_state, make_train_step

    cfg = PHI35_MOE.replace(num_layers=MOE_LAYERS, moe_prune_unit="expert")
    targets = MOE_FAMILY_TARGETS
    env = InferenceEnv(hw=H100_SXM, **FAMILY_ENV)
    tcfg = gradual_train_config(MOE_FAMILY_KW["finetune_steps"])
    mods = registry(cfg)
    by_name = {m.name: m for m in mods}
    table = build_table(cfg, env, "costmodel", device="cuda")
    dense = table.dense_runtime(mods)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_moe_family_")

    def data(step):
        return synthetic_stream(cfg, FAMILY_BATCH, FAMILY_SEQ, seed=0,
                                start_step=step)

    try:
        print(f"MoE family: {cfg.name} layers={cfg.num_layers} of "
              f"{PHI35_MOE.num_layers} in {cfg.moe_prune_unit} mode "
              f"({len(mods)} modules); phase 7's weights and its "
              f"{len(calib)} calibration batches; targets {targets}, "
              f"{MOE_FAMILY_KW}, {tcfg} (gradual_prune's default), "
              f"batches {FAMILY_BATCH} x {FAMILY_SEQ}, cost-model env "
              f"{FAMILY_ENV} on {H100_SXM}; disk free "
              f"{shutil.disk_usage(tmp).free} B")
        print(f"MoE family: cost-model dense runtime {dense * 1e3:.6f} ms, "
              f"of which no unit can remove {table.base * 1e3:.6f} ms "
              f"({table.base / dense:.4f}: embedding, norms and the logits "
              f"head): a member is at most {dense / table.base:.4f}x faster")
        run_dir = family_run_dir(cfg, targets, 0, tmp)
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        fam = gradual_prune(cfg, params, env, targets, data, calib,
                            tcfg=tcfg, ckpt_dir=tmp, seed=0, overlap=True,
                            keep_checkpoints=False, device="cuda",
                            **MOE_FAMILY_KW)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = {k.__name__: k.launches for k in kernels.KERNELS}
        peak = torch.cuda.max_memory_allocated() / 2**30
        man = load_json(os.path.join(run_dir, "family.json"))
        print(f"MoE family: run {run_s:.3f} s, peak device memory "
              f"{peak:.2f} GiB, launches {launches}; bytes by artifact "
              "kind (the checkpoints removed) "
              + json.dumps(_artifact_bytes(run_dir)))

        tokens = calib[0]["tokens"].cuda()
        old_cf = moe.CAPACITY_FACTOR
        orders = {}
        for t, v in zip(targets, fam):
            e = man["targets"][f"{t:g}"]
            with np.load(os.path.join(run_dir, f"t{t:g}", "db.npz")) as f:
                orders[t] = {n: _order_db(by_name[n], f[f"{n}::order"])
                             for n in v.assignment}
            dropped = sorted(n for n, r in v.assignment.items()
                             if ".expert" in n and r == cfg.d_ff)
            print(f"  target {t}x: achieved {v.achieved:.4f}x (cost model), "
                  f"KV groups removed {v.assignment['L0.attn']} of "
                  f"{cfg.num_kv_heads}, experts dropped {len(dropped)} of "
                  f"{cfg.num_experts} {dropped}, loss "
                  f"{v.loss_before_ft:.5f} -> {v.loss_after_ft:.5f}, shrunk "
                  f"params {v.pruned.num_params()}; stage seconds "
                  + json.dumps({k: round(x, 4) for k, x in
                                e["stage_times"].items()}))
            check(v.achieved >= t, f"MoE family {t}x not met: "
                  f"{v.achieved:.4f}x")
            check(all(r in (0, cfg.d_ff) for n, r in v.assignment.items()
                      if ".expert" in n),
                  f"MoE family {t}x: an expert is neither kept nor dropped")
            check(math.isfinite(v.loss_after_ft),
                  f"MoE family {t}x: non-finite loss")
            check(rows_zero(torch, v.params, orders[t], v.assignment),
                  f"MoE family {t}x: a masked row is not 0 after the "
                  "finetune")
            with torch.no_grad():
                moe.CAPACITY_FACTOR = NO_DROPS
                try:
                    want = forward(cfg, v.params, tokens)["logits"]
                finally:
                    moe.CAPACITY_FACTOR = old_cf
                got = forward_pruned(v.pruned, tokens)
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            finite = bool(torch.isfinite(got).all())
            layers = v.pruned.layers
            print(f"  target {t}x: KV heads {[l.kv_groups for l in layers]}"
                  f", expert widths {[l.expert_ff for l in layers]}"
                  f"; masked rows 0; shrunk vs masked logits (capacity "
                  f"factor {NO_DROPS} on the masked side) on "
                  f"{tuple(tokens.shape)} tokens max_abs_err={err:.4e} "
                  f"(scale {scale:.4e}, tol {STITCHED_TOL:g}*scale), finite "
                  f"{finite}")
            check(finite and err <= STITCHED_TOL * scale,
                  f"MoE family {t}x: the shrunk member's logits disagree")
            del want, got
        for name in MOE_FAMILY_KERNELS:
            check(launches[name] > 0, f"{name} never launched on phase 11")
        check(launches["flash_attention"] == 0,
              "flash_attention launched on phase 11, whose attention is "
              "dense below 2048 tokens")

        # determinism: the last member's finetune step (dense teacher, its
        # masks) twice from one state, MOE_REPEAT_STEPS steps each
        t, v = targets[-1], fam[-1]
        student, assignment = v.params, v.assignment
        del fam, v
        torch.cuda.empty_cache()
        step = make_train_step(
            cfg, tcfg, teacher_params=params, device="cuda",
            masks=masks_from_assignment(cfg, student, orders[t],
                                        assignment))
        batches = [b for b, _ in zip(data(0), range(MOE_REPEAT_STEPS))]
        digests, times = [], []
        for _ in range(2):
            state = make_train_state(cfg, student, tcfg)
            for b in batches:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, metrics = step(state, b)
                check(math.isfinite(float(metrics["loss"])),
                      "MoE train step: non-finite loss")
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            digests.append(state_digest(torch, state))
            del state
        same = torch.equal(digests[0], digests[1])
        print(f"MoE family: {MOE_REPEAT_STEPS} train steps of the {t}x "
              f"member (dense teacher, its masks, {FAMILY_BATCH} x "
              f"{FAMILY_SEQ} tokens) repeated from one state: params, m "
              f"and v bit-equal (digests of {digests[0].shape[0]} leaves) "
              f"{same}; step seconds {[round(x, 4) for x in times]}")
        check(same, "two MoE train steps from one state differ")
        del student, step
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _order_db(mod, order):
    """A ModuleDB holding only a module and its removal order: what
    ``masks_from_assignment`` and ``rows_zero`` read."""
    from repro_torch.core.database import ModuleDB
    return ModuleDB(mod=mod, levels=None, snapshots=None, errors=None,
                    priors=None, base_norm=0.0, order=order)


# phase 12: two of the port's examples on the card, through their main()
# with their defaults, as a user runs them (the other two examples' entry
# points, FamilyServer/generate and gradual_prune, run on the card in
# phases 5 and 9)
EXAMPLE_RUNS = [("torch_quickstart", []),
                ("torch_oneshot_prune_arch", ["--arch",
                                              "phi3.5-moe-42b-a6.6b"])]


def run_examples(torch, kernels):
    """Phase 12: each of EXAMPLE_RUNS loaded from ``examples/`` and its
    ``main`` called; every member it prices must meet its target."""
    import importlib.util
    for name, argv in EXAMPLE_RUNS:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(ROOT, "examples", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = mod.main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        res = out[0] if isinstance(out, tuple) else out
        launches = {k.__name__: k.launches for k in kernels.KERNELS}
        speedups = {t: round(float(v.speedup), 4)
                    for t, v in res.variants.items()}
        print(f"example {name} {' '.join(argv)}: {secs:.3f} s on the card "
              f"(default --device), speedups {speedups}, launches "
              f"{launches}")
        for t, v in res.variants.items():
            check(v.speedup >= t, f"example {name}: {t}x not met: "
                  f"{v.speedup:.4f}x")
        check(launches["hessian_accum"] > 0 and launches["obs_downdate"] > 0,
              f"example {name}: the calibration and database kernels never "
              "launched")


# phase 13: Hymba-1.5B (configs/hymba_1p5b.py, arXiv:2411.13676) at full
# width with 4 of its 32 layers and seeded weights: every layer runs 25
# attention heads on 5 KV heads (a 1024-token window) and 25 SSD heads of
# 64 (state 16, chunk 256) side by side, then its d_ff 5504 FFN. A layer's
# database keeps about 0.92 GB of fp16 snapshots (FFN, SSD heads, KV
# groups) and 141 MB of fp32 Hessians
HYBRID_LAYERS = 4
# the tied logits head (2048 x 1600 x 32001) bounds every member's speedup:
# the measured table's ceiling is 1.9388x (NVIDIA H100 80GB HBM3, 700 W),
# so 1.25x and 1.5x stay and the 2x target, above it, became 1.72x (0.89
# of the ceiling)
HYBRID_TARGETS = [1.25, 1.5, 1.72]
HYBRID_CEILING = 1.9388
# one full-width hybrid layer's forward at HYBRID_LONG tokens, where "auto"
# attention runs the flash kernel (past 2048 tokens), against dense
# attention: the logits within 2e-2 of their scale
HYBRID_LONG = 4096
HYBRID_LONG_TOL = 2e-2
HYBRID_KERNELS = ("hessian_accum", "obs_downdate", "ssd_intra_chunk")


def run_hybrid_path(torch, kernels):
    """Phase 13: oneshot_prune on Hymba-1.5B, shrink, and a long forward."""
    import numpy as np
    from repro_torch.configs import HYMBA_1P5B
    from repro_torch.core import database
    from repro_torch.core.database import apply_assignment
    from repro_torch.core.oneshot import oneshot_prune
    from repro_torch.core.shrink import shrink, shrink_from_stitched
    from repro_torch.data import calibration_batches
    from repro_torch.models import forward, model_init
    from repro_torch.models.pruned import forward_pruned
    from repro_torch.runtime.costmodel import InferenceEnv

    cfg = HYMBA_1P5B.replace(num_layers=HYBRID_LAYERS)
    t0 = time.perf_counter()
    params = model_init(cfg, torch.Generator().manual_seed(0), device="cuda")
    calib = calibration_batches(cfg, 32, 512, batch=8)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    env = InferenceEnv(batch=16, seq=128, mode="prefill", hw=None)
    targets = HYBRID_TARGETS
    print(f"Hymba path: {cfg.name} layers={cfg.num_layers} of "
          f"{HYMBA_1P5B.num_layers} d_model={cfg.d_model} attention "
          f"{cfg.num_heads}x{cfg.resolved_head_dim} on {cfg.num_kv_heads} KV "
          f"heads window={cfg.window_size}, SSD {cfg.ssm_heads}x"
          f"{cfg.ssm_head_dim} state={cfg.ssm_state} chunk={cfg.ssm_chunk}, "
          f"d_ff={cfg.d_ff} vocab={cfg.vocab_size} dtype={cfg.dtype}; "
          f"calibration 32 x 512 tokens in batches of 8; env batch="
          f"{env.batch} seq={env.seq} {env.mode}, measured table "
          f"({LATENCY_KW}); targets {targets}")

    kernels.reset_launch_counts()
    database.reset_snapshot_traffic()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = oneshot_prune(cfg, params, calib, env, targets,
                        latency_backend="measure", latency_kw=LATENCY_KW,
                        search_steps=48, search_pop=16, seed=0,
                        device="cuda")
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels.KERNELS}
    traffic = dict(database.SNAPSHOT_TRAFFIC)
    snap_bytes = sum(m.snapshots.nbytes for m in res.db.values())
    levels = {m.mod.kind: len(m.levels) for m in res.db.values()}
    print(f"Hymba path: setup (weights + tokens) {setup_s:.3f} s, "
          f"oneshot_prune {total_s:.3f} s, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
          f"{len(res.db)} modules, levels {levels}, database snapshots "
          f"{snap_bytes} bytes ({snap_bytes / cfg.num_layers / 1e9:.3f} GB a "
          f"layer); host round trip: fetch {traffic['fetch_bytes']} bytes in "
          f"{traffic['fetch_s']:.3f} s, upload {traffic['upload_bytes']} bytes"
          f" in {traffic['upload_s']:.3f} s")
    print("Hymba stage seconds: " + json.dumps(
        {k: round(v, 4) for k, v in res.stage_seconds.items()}))
    print(f"Hymba path launches: {launches}")
    print(f"Hymba table: base {res.table.base * 1e3:.4f} ms, " + ", ".join(
        f"{k} levels {res.table.grids[k].tolist()} ms "
        f"{[round(float(x) * 1e3, 4) for x in res.table.times[k]]}"
        for k in res.table.grids))
    print(f"Hymba dense: calibration loss {res.dense_loss:.4f}")
    check_ceiling(res, HYBRID_CEILING, "Hymba path")
    check(math.isfinite(res.dense_loss), "Hymba: non-finite dense loss")
    for t in targets:
        v = res.variants[t]
        kinds = {k: sum(r for n, r in v.assignment.items()
                        if n.endswith("." + k)) for k in levels}
        print(f"  target {t}x: speedup {v.speedup:.3f}x, runtime "
              f"{v.runtime * 1e3:.4f} ms, loss {v.calib_loss:.4f}, removed "
              f"{kinds} (KV groups, SSD heads, FFN rows), evals "
              f"{v.search.n_evals}")
        check(v.speedup >= t, f"Hymba target {t}x not met: {v.speedup:.4f}x")
        check(math.isfinite(v.calib_loss), f"Hymba {t}x: non-finite loss")
        for grp, leaf in (("attn", "wo"), ("ssm", "out_proj"), ("ffn", "wd")):
            w = v.params["layers"][grp][leaf]
            check(w.shape == params["layers"][grp][leaf].shape
                  and bool(torch.isfinite(w).all()),
                  f"Hymba {t}x: {leaf} has the wrong shape or non-finite "
                  "values")
    for name in HYBRID_KERNELS:
        check(launches[name] > 0, f"{name} never launched on the Hymba path")
    fam = check_prior_family(torch, cfg, params, calib, res, targets)

    tokens = calib[0]["tokens"].cuda()
    with torch.no_grad():
        for t in targets:
            a = fam[t].assignment
            stitched = apply_assignment(cfg, params, res.db, a)
            host_pm = shrink(cfg, params, res.db, a, device="cuda")
            dev_pm = shrink_from_stitched(cfg, stitched, res.db, a)
            hl, dl = (_leaves([l.params for l in pm.layers] + [pm.globals_])
                      for pm in (host_pm, dev_pm))
            shape = [(l.kv_groups, l.ssm_heads, l.d_ff)
                     for l in host_pm.layers]
            same = len(hl) == len(dl) and all(
                x.dtype == y.dtype and torch.equal(x, y)
                for x, y in zip(hl, dl)) and shape == [
                (l.kv_groups, l.ssm_heads, l.d_ff) for l in dev_pm.layers]
            zero = rows_zero(torch, stitched, res.db, a)
            want = forward(cfg, stitched, tokens)["logits"]
            got = forward_pruned(host_pm, tokens)
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            finite = bool(torch.isfinite(got).all())
            print(f"  prior-scored {t}x shrunk: (KV groups, SSD heads, d_ff) "
                  f"per layer {shape}, params {host_pm.num_params()}, "
                  f"shrink_from_stitched == shrink ({len(hl)} leaves "
                  f"bit-equal): {same}; masked rows 0: {zero}; logits vs "
                  f"stitched on {tuple(tokens.shape)} tokens max_abs_err="
                  f"{err:.4e} (scale {scale:.4e}, tol {STITCHED_TOL:g}*scale)"
                  f", finite {finite}")
            check(same, f"Hymba {t}x: shrink_from_stitched differs from "
                  "shrink")
            check(zero, f"Hymba {t}x: a removed structure's rows are not 0")
            check(finite and err <= STITCHED_TOL * scale,
                  f"Hymba {t}x: shrunk logits disagree with the stitched "
                  "model")
            del stitched, host_pm, dev_pm, want, got
    del res, fam, calib, tokens
    torch.cuda.empty_cache()

    # one hybrid layer at HYBRID_LONG tokens: flash (auto) against dense
    one = cfg.replace(num_layers=1)
    p1 = {**params, "layers": {grp: {k: v[:1] for k, v in sub.items()}
                               for grp, sub in params["layers"].items()}}
    long = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, HYBRID_LONG))).cuda()
    before = {k.__name__: k.launches for k in kernels.KERNELS}
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = forward(one, p1, long)["logits"]
        torch.cuda.synchronize()
        long_s = time.perf_counter() - t0
        long_launches = {k.__name__: k.launches - before[k.__name__]
                         for k in kernels.KERNELS}
        want = forward(one.replace(attn_impl="dense"), p1, long)["logits"]
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    finite = bool(torch.isfinite(got).all())
    print(f"Hymba long forward: 1 layer, {tuple(long.shape)} tokens, "
          f"attn_impl=auto in {long_s:.3f} s (launches {long_launches}); "
          f"logits vs attn_impl=dense max_abs_err={err:.4e} (scale "
          f"{scale:.4e}, tol {HYBRID_LONG_TOL:g}*scale), finite {finite}")
    check(finite and err <= HYBRID_LONG_TOL * scale,
          "Hymba long forward: flash disagrees with dense attention")
    check(long_launches["flash_attention"] > 0
          and long_launches["ssd_intra_chunk"] > 0,
          "Hymba long forward: flash or the SSD kernel never launched")
    del got, want, params, p1
    for name, n in long_launches.items():
        launches[name] += n
    return launches


# phase 14: Whisper-large-v3 (configs/whisper_large_v3.py, arXiv:2212.04356)
# at full width: the encoder at 8 of its 32 layers over (8, 1500, 1280)
# frame embeddings, and 4 of the 32 decoder layers (d_model 1280, 20 heads
# of 64, d_ff 5120, vocab 51866 tied). Only the decoder's units are pruned
# and priced, as in the reference; the encoder and the cross-attention stay
# dense, so the encoder's depth moves no speedup or ceiling: it ran all 32
# layers (search 9.67 s, most of it the encoder re-run for each scored
# candidate) until phase 15 took the script to 1155 s. The weights are
# drawn on the card's generator (the host's takes over a minute for
# them) and the gates opened (``open_gates``)
ENCDEC_LAYERS = 4
ENCDEC_ENCODER_LAYERS = 8
# the tied logits head (2048 x 1280 x 51866) bounds every member's speedup:
# the measured table's ceiling is 1.8796x (NVIDIA H100 80GB HBM3, 700 W),
# so 1.25x and 1.5x stay and the 2x target, above it, became 1.67x (0.89
# of the ceiling)
ENCDEC_TARGETS = [1.25, 1.5, 1.67]
ENCDEC_CEILING = 1.8796
# greedy decoding through the cross cache in fp32, 8 tokens after a
# 32-token prompt: each position's logits within the reference's 2e-3 abs
# + 1e-2 rel of the full forward's (tests/test_models_smoke.py)
ENCDEC_PROMPT, ENCDEC_STEPS = 32, 8
ENCDEC_TOL = (2e-3, 1e-2)
ENCDEC_KERNELS = ("hessian_accum", "obs_downdate")


def check_cross_decode(torch, cfg, params, prompt, frames, what):
    """Greedy ``generate(frontend=...)`` of ENCDEC_STEPS tokens, then the
    same prefill and decode steps by hand: each step's logits against the
    full forward over the prompt and the generated tokens (ENCDEC_TOL),
    and their argmax against the generated tokens."""
    from repro_torch.models import forward, generate, serve_prefill, serve_step
    s = prompt.shape[1]
    atol, rtol = ENCDEC_TOL
    with torch.no_grad():
        toks = generate(cfg, params, prompt, ENCDEC_STEPS, frontend=frames)
        full = forward(cfg, params, torch.cat([prompt, toks], 1),
                       frontend_embeds=frames)["logits"]
        logits, cache = serve_prefill(
            cfg, params, {"tokens": prompt, "frontend": frames},
            max_len=s + ENCDEC_STEPS)
        worst, within, greedy = 0.0, True, True
        for t in range(ENCDEC_STEPS):
            want, got = full[:, s - 1 + t], logits[:, 0]
            diff = (got - want).abs()
            worst = max(worst, float(diff.max()))
            within = within and bool((diff <= atol + rtol * want.abs()).all())
            greedy = greedy and torch.equal(got.argmax(-1), toks[:, t])
            if t + 1 < ENCDEC_STEPS:
                logits, cache = serve_step(cfg, params, cache,
                                           toks[:, t:t + 1])
    print(f"  {what} fp32: greedy decode of {ENCDEC_STEPS} tokens after "
          f"{tuple(prompt.shape)} prompts through the cross cache "
          f"{tuple(cache['cross']['k'].shape)}: logits vs the full forward "
          f"max_abs_err={worst:.3e} (tol {atol:g} + {rtol:g}*|logit|) "
          f"{'ok' if within else 'MISMATCH'}; argmax == generated tokens: "
          f"{greedy}")
    check(within, f"{what}: decoded logits disagree with the full forward")
    check(greedy, f"{what}: generate's tokens are not the argmax of its "
          "logits")


def run_encdec_path(torch, kernels):
    """Phase 14: oneshot_prune on Whisper-large-v3 (encoder 32 layers,
    decoder ENCDEC_LAYERS), then the frames' effect and fp32 decoding."""
    from repro_torch.configs import WHISPER_LARGE_V3
    from repro_torch.core import database
    from repro_torch.core.oneshot import oneshot_prune
    from repro_torch.data import calibration_batches
    from repro_torch.models import forward, model_init
    from repro_torch.runtime.costmodel import InferenceEnv

    cfg = WHISPER_LARGE_V3.replace(num_layers=ENCDEC_LAYERS,
                                   num_encoder_layers=ENCDEC_ENCODER_LAYERS)
    t0 = time.perf_counter()
    params = model_init(cfg, torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    open_gates(torch, params, 0)
    calib = calibration_batches(cfg, 32, 512, batch=8)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    gates = [round(math.tanh(g), 4) for g in cross_gates(params).tolist()]
    env = InferenceEnv(batch=16, seq=128, mode="prefill", hw=None)
    targets = ENCDEC_TARGETS
    print(f"Whisper path: {cfg.name} encoder {cfg.num_encoder_layers} "
          f"layers over {cfg.num_frontend_tokens} x {cfg.frontend_dim} "
          f"frames ({WHISPER_LARGE_V3.num_encoder_layers} in the model), "
          f"decoder {cfg.num_layers} of {WHISPER_LARGE_V3.num_layers}"
          f" layers, d_model={cfg.d_model} {cfg.num_heads}x"
          f"{cfg.resolved_head_dim} heads, d_ff={cfg.d_ff} vocab="
          f"{cfg.vocab_size} dtype={cfg.dtype}, {n_params} parameters; gates "
          f"tanh {gates}; calibration 32 x 512 tokens in batches of 8, each "
          f"with {tuple(calib[0]['frontend'].shape)} frames; env batch="
          f"{env.batch} seq={env.seq} {env.mode}, measured table "
          f"({LATENCY_KW}); targets {targets}")

    kernels.reset_launch_counts()
    database.reset_snapshot_traffic()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = oneshot_prune(cfg, params, calib, env, targets,
                        latency_backend="measure", latency_kw=LATENCY_KW,
                        search_steps=48, search_pop=16, seed=0,
                        device="cuda")
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels.KERNELS}
    traffic = dict(database.SNAPSHOT_TRAFFIC)
    snap_bytes = sum(m.snapshots.nbytes for m in res.db.values())
    levels = {m.mod.kind: len(m.levels) for m in res.db.values()}
    print(f"Whisper path: setup (weights + tokens + frames) {setup_s:.3f} s,"
          f" oneshot_prune {total_s:.3f} s, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
          f"{len(res.db)} modules, levels {levels}, database snapshots "
          f"{snap_bytes} bytes ({snap_bytes / cfg.num_layers / 1e9:.3f} GB a "
          f"layer); host round trip: fetch {traffic['fetch_bytes']} bytes in "
          f"{traffic['fetch_s']:.3f} s, upload {traffic['upload_bytes']} bytes"
          f" in {traffic['upload_s']:.3f} s")
    print("Whisper stage seconds: " + json.dumps(
        {k: round(v, 4) for k, v in res.stage_seconds.items()}))
    print(f"Whisper path launches: {launches}")
    print(f"Whisper table: base {res.table.base * 1e3:.4f} ms, " + ", ".join(
        f"{k} levels {res.table.grids[k].tolist()} ms "
        f"{[round(float(x) * 1e3, 4) for x in res.table.times[k]]}"
        for k in res.table.grids))
    print(f"Whisper dense: calibration loss {res.dense_loss:.4f}")
    check_ceiling(res, ENCDEC_CEILING, "Whisper path")
    check(math.isfinite(res.dense_loss), "Whisper: non-finite dense loss")
    for t in targets:
        v = res.variants[t]
        kinds = {k: sum(r for n, r in v.assignment.items()
                        if n.endswith("." + k)) for k in levels}
        zero = rows_zero(torch, v.params, res.db, v.assignment)
        print(f"  target {t}x: speedup {v.speedup:.3f}x, runtime "
              f"{v.runtime * 1e3:.4f} ms, loss {v.calib_loss:.4f}, removed "
              f"{kinds} (KV groups, FFN rows), per module "
              f"{dict(sorted(v.assignment.items()))}, evals "
              f"{v.search.n_evals}; removed rows 0: {zero}")
        check(v.speedup >= t, f"Whisper target {t}x not met: "
              f"{v.speedup:.4f}x")
        check(math.isfinite(v.calib_loss), f"Whisper {t}x: non-finite loss")
        check(zero, f"Whisper {t}x: a removed structure's rows are not 0")
        for grp, leaf in (("attn", "wo"), ("ffn", "wd")):
            w = v.params["layers"][grp][leaf]
            check(w.shape == params["layers"][grp][leaf].shape
                  and bool(torch.isfinite(w).all()),
                  f"Whisper {t}x: {leaf} has the wrong shape or non-finite "
                  "values")
    for name in ENCDEC_KERNELS:
        check(launches[name] > 0, f"{name} never launched on the Whisper "
              "path")

    top = targets[-1]
    member = res.variants[top].params
    tokens = calib[0]["tokens"].cuda()
    with torch.no_grad():
        for what, p in (("dense", params), (f"{top}x member", member)):
            a = forward(cfg, p, tokens, frontend_embeds=calib[0]["frontend"])
            b = forward(cfg, p, tokens, frontend_embeds=calib[1]["frontend"])
            moved = float((a["logits"] - b["logits"]).abs().max())
            scale = float(a["logits"].abs().max())
            print(f"  {what}: logits on {tuple(tokens.shape)} tokens move by "
                  f"{moved:.4e} (scale {scale:.4e}) when the frames change")
            check(moved > 1e-2 * scale, f"Whisper {what}: the frames do not "
                  "reach the logits")
            del a, b
    prompt = tokens[:2, :ENCDEC_PROMPT]
    frames = calib[0]["frontend"][:2].float().cuda()
    del res, calib
    torch.cuda.empty_cache()
    cfg32 = cfg.replace(dtype="float32")
    for what, p in (("dense", params), (f"{top}x member", member)):
        check_cross_decode(torch, cfg32, p, prompt, frames,
                           f"Whisper {what}")
    return launches


# phase 15: Llama-3.2-Vision-11B (configs/llama32_vision_11b.py,
# hf:meta-llama/Llama-3.2-11B-Vision) at full width (d_model 4096, 32 heads
# on 8 KV heads of 128, d_ff 14336 SwiGLU, vocab 128256 tied, RoPE theta
# 5e5) with one cross group: 5 self layers and the cross-attention module
# after them, over (8, 1601, 4096) patch embeddings. Only the self layers'
# units are pruned and priced, as in the reference; the cross module stays
# dense. The 1.66 B weights are drawn on the card's generator and the gate
# opened (``open_gates``). A layer's database keeps 5.3 GB of fp16
# snapshots (44 FFN levels of 14336 x 4096, 9 attention levels of 4096 x
# 4096), 27.3 GB in all, through host memory
VLM_LAYERS = 5
# the tied logits head (2048 x 4096 x 128256, 2.6432 ms) against five
# self layers: the measured table's ceiling is 2.9794x (NVIDIA H100 80GB
# HBM3, 700 W), so the 2x target lies under 0.9 of it and every target
# stays
VLM_TARGETS = [1.25, 1.5, 2.0]
VLM_CEILING = 2.9794
VLM_KERNELS = ("hessian_accum", "obs_downdate")


def run_vlm_path(torch, kernels):
    """Phase 15: oneshot_prune on Llama-3.2-Vision-11B (one cross group),
    then the frames' effect and fp32 decoding through the grouped cross
    cache."""
    from repro_torch.configs import LLAMA32_VISION_11B
    from repro_torch.core import database
    from repro_torch.core.oneshot import oneshot_prune
    from repro_torch.data import calibration_batches
    from repro_torch.models import forward, model_init
    from repro_torch.runtime.costmodel import InferenceEnv

    cfg = LLAMA32_VISION_11B.replace(num_layers=VLM_LAYERS)
    t0 = time.perf_counter()
    params = model_init(cfg, torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    open_gates(torch, params, 0)
    calib = calibration_batches(cfg, 32, 512, batch=8)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    gates = [round(math.tanh(g), 4) for g in cross_gates(params).tolist()]
    env = InferenceEnv(batch=16, seq=128, mode="prefill", hw=None)
    targets = VLM_TARGETS
    print(f"VLM path: {cfg.name} {cfg.num_layers} of "
          f"{LLAMA32_VISION_11B.num_layers} self layers with a cross module "
          f"after every {cfg.cross_attn_every} ({len(gates)} here) over "
          f"{cfg.num_frontend_tokens} x {cfg.frontend_dim} patches, "
          f"d_model={cfg.d_model} {cfg.num_heads}/{cfg.num_kv_heads}x"
          f"{cfg.resolved_head_dim} heads, d_ff={cfg.d_ff} vocab="
          f"{cfg.vocab_size} dtype={cfg.dtype}, {n_params} parameters, "
          f"frontend_proj: {'frontend_proj' in params}; gates tanh {gates}; "
          f"calibration 32 x 512 tokens in batches of 8, each with "
          f"{tuple(calib[0]['frontend'].shape)} frames; env batch="
          f"{env.batch} seq={env.seq} {env.mode}, measured table "
          f"({LATENCY_KW}); targets {targets}")

    kernels.reset_launch_counts()
    database.reset_snapshot_traffic()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = oneshot_prune(cfg, params, calib, env, targets,
                        latency_backend="measure", latency_kw=LATENCY_KW,
                        search_steps=48, search_pop=16, seed=0,
                        device="cuda")
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels.KERNELS}
    traffic = dict(database.SNAPSHOT_TRAFFIC)
    snap_bytes = sum(m.snapshots.nbytes for m in res.db.values())
    levels = {m.mod.kind: len(m.levels) for m in res.db.values()}
    print(f"VLM path: setup (weights + tokens + frames) {setup_s:.3f} s, "
          f"oneshot_prune {total_s:.3f} s, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
          f"{len(res.db)} modules, levels {levels}, database snapshots "
          f"{snap_bytes} bytes ({snap_bytes / cfg.num_layers / 1e9:.3f} GB a "
          f"layer); host round trip: fetch {traffic['fetch_bytes']} bytes in "
          f"{traffic['fetch_s']:.3f} s, upload {traffic['upload_bytes']} bytes"
          f" in {traffic['upload_s']:.3f} s")
    print("VLM stage seconds: " + json.dumps(
        {k: round(v, 4) for k, v in res.stage_seconds.items()}))
    print(f"VLM path launches: {launches}")
    print(f"VLM table: base {res.table.base * 1e3:.4f} ms, " + ", ".join(
        f"{k} levels {res.table.grids[k].tolist()} ms "
        f"{[round(float(x) * 1e3, 4) for x in res.table.times[k]]}"
        for k in res.table.grids))
    print(f"VLM dense: calibration loss {res.dense_loss:.4f}")
    check_ceiling(res, VLM_CEILING, "VLM path")
    check(math.isfinite(res.dense_loss), "VLM: non-finite dense loss")
    for t in targets:
        v = res.variants[t]
        kinds = {k: sum(r for n, r in v.assignment.items()
                        if n.endswith("." + k)) for k in levels}
        zero = rows_zero(torch, v.params, res.db, v.assignment)
        print(f"  target {t}x: speedup {v.speedup:.3f}x, runtime "
              f"{v.runtime * 1e3:.4f} ms, loss {v.calib_loss:.4f}, removed "
              f"{kinds} (KV groups, FFN rows), per module "
              f"{dict(sorted(v.assignment.items()))}, evals "
              f"{v.search.n_evals}; removed rows 0: {zero}")
        check(v.speedup >= t, f"VLM target {t}x not met: {v.speedup:.4f}x")
        check(math.isfinite(v.calib_loss), f"VLM {t}x: non-finite loss")
        check(zero, f"VLM {t}x: a removed structure's rows are not 0")
        for grp, leaf in (("attn", "wo"), ("ffn", "wd")):
            w = v.params["layers"][grp][leaf]
            check(w.shape == params["layers"][grp][leaf].shape
                  and bool(torch.isfinite(w).all()),
                  f"VLM {t}x: {leaf} has the wrong shape or non-finite "
                  "values")
        check(all(torch.equal(a, b) for a, b in zip(
            _leaves(v.params["cross"]), _leaves(params["cross"]))),
            f"VLM {t}x: the cross module is not the dense model's")
    for name in VLM_KERNELS:
        check(launches[name] > 0, f"{name} never launched on the VLM path")

    top = targets[-1]
    member = res.variants[top].params
    tokens = calib[0]["tokens"].cuda()
    with torch.no_grad():
        for what, p in (("dense", params), (f"{top}x member", member)):
            a = forward(cfg, p, tokens, frontend_embeds=calib[0]["frontend"])
            b = forward(cfg, p, tokens, frontend_embeds=calib[1]["frontend"])
            moved = float((a["logits"] - b["logits"]).abs().max())
            scale = float(a["logits"].abs().max())
            print(f"  {what}: logits on {tuple(tokens.shape)} tokens move by "
                  f"{moved:.4e} (scale {scale:.4e}) when the frames change")
            check(moved > 1e-2 * scale, f"VLM {what}: the frames do not "
                  "reach the logits")
            del a, b
    prompt = tokens[:2, :ENCDEC_PROMPT]
    frames = calib[0]["frontend"][:2].float().cuda()
    del res
    torch.cuda.empty_cache()
    cfg32 = cfg.replace(dtype="float32")
    for what, p in (("dense", params), (f"{top}x member", member)):
        check_cross_decode(torch, cfg32, p, prompt, frames, f"VLM {what}")
    return launches, cfg, params, calib


# phase 16: latency and search. (b) and (c) run right after phase 4, on its
# GPT-2 database and measured table; (a) runs after phase 15, on the first
# self layer of its Llama-3.2-Vision-11B: the FFN module (14336 rows, gs
# 1, d_out 4096; 15 segments, a downdate on the live prefix of a padded
# working set) and the KV-group module (8 groups of 512 wo_in rows, gs
# 512; 6 segments, compacted at 6 live groups), each built on the plain
# and on the compacted route at M = 1. The schedule predicts the
# compacted FFN run's Hinv traffic at 0.443 of the plain run's
COMPACT_KERNELS = ("obs_downdate",)
# (b)'s placed search: one card named twice, a stream a list position
PLACED_DEVICES = ["cuda:0", "cuda:0"]
# one float16 rounding of either side: |a - b| <= 2^-10 max(|a|, |b|),
# plus float16's smallest subnormal
F16_ULP = 2.0 ** -10
F16_TINY = 2.0 ** -24


def run_search_paths(torch, cfg, params, calib, db, table):
    """Phase 16 (b): the serial SPDY search (``batched=False``: the
    scalar DP, candidates scored one by one) against the batched one on
    phase 4's database and measured table, for its targets: bit for bit
    on the analytic score, scores within 1e-6 relative when scored by the
    calibration loss (serial ``eval_fn`` against batched
    ``eval_batched``); and the loss-scored search placed over
    ``PLACED_DEVICES`` (two streams of the card) bit for bit the batched
    one."""
    from repro_torch.core import spdy
    from repro_torch.core.database import SnapshotCache
    from repro_torch.core.oneshot import calib_loss_fn, make_batched_eval
    from repro_torch.core.spdy import search_family

    seconds = {}

    def timed(label, **kw):
        t0 = time.perf_counter()
        out = search_family(db, table, MAIN_TARGETS, steps=48, pop=16,
                            seed=0, **kw)
        torch.cuda.synchronize()
        seconds[label] = time.perf_counter() - t0
        return out

    batched = timed("analytic batched")
    serial = timed("analytic serial", batched=False)
    for t in MAIN_TARGETS:
        b, s = batched[t], serial[t]
        print(f"  analytic {t}x: serial speedup {s.speedup:.4f}x score "
              f"{s.score!r}, batched {b.speedup:.4f}x score {b.score!r}, "
              f"evals {s.n_evals}/{b.n_evals}")
        check(s.assignment == b.assignment and s.score == b.score
              and s.history == b.history and s.runtime == b.runtime,
              f"serial search at {t}x is not the batched search bit for "
              "bit on the analytic score")
    cache = SnapshotCache(cfg, db, device="cuda")
    loss = calib_loss_fn(cfg, calib[:1], device="cuda")
    lb = timed("loss batched", eval_batched=make_batched_eval(
        cfg, params, cache, calib[:1], device="cuda"))
    # placed on two streams of the card, one thread a target's partition
    spdy.reset_placed_scoring()
    lp = timed("loss placed", devices=PLACED_DEVICES,
               eval_batched=make_batched_eval(cfg, params, cache, calib[:1],
                                              device="cuda"))
    placed = dict(spdy.PLACED_SCORING)
    print(f"  placed over {PLACED_DEVICES}: {placed['calls']} scorer calls, "
          f"candidates scored by target {placed['scored']}")
    for t in MAIN_TARGETS:
        b, p = lb[t], lp[t]
        check(p.assignment == b.assignment and p.score == b.score
              and p.history == b.history and p.runtime == b.runtime
              and p.n_evals == b.n_evals,
              f"placed search at {t}x is not the batched search bit for "
              f"bit: score {p.score!r} against {b.score!r}")
    check(sum(placed["scored"].values()) == lb[MAIN_TARGETS[0]].n_evals
          and placed["calls"] > len(placed["scored"]),
          f"the placed search did not place its rounds: {placed}")
    ls = timed("loss serial", batched=False,
               eval_fn=lambda a: loss(cache.apply(params, a)))
    for t in MAIN_TARGETS:
        b, s = lb[t], ls[t]
        rel = abs(s.score - b.score) / max(abs(b.score), 1e-30)
        print(f"  loss-scored {t}x: serial speedup {s.speedup:.4f}x score "
              f"{s.score:.6f}, batched {b.speedup:.4f}x score "
              f"{b.score:.6f} (relative {rel:.3e}), same assignment: "
              f"{s.assignment == b.assignment}, evals {s.n_evals}/"
              f"{b.n_evals}")
        check(rel <= 1e-6, f"loss-scored serial search at {t}x: score "
              f"{s.score} against the batched {b.score}")
        check(s.speedup >= t and b.speedup >= t,
              f"loss-scored search at {t}x: a target not met")
    print("search seconds: " + json.dumps(
        {k: round(v, 4) for k, v in seconds.items()}))
    del cache
    torch.cuda.empty_cache()
    return seconds


def run_cache_path(torch, cfg, db, table):
    """Phase 16 (c): phase 4's measured table built through the
    persistent latency cache in a temporary directory, then again: the
    second call times nothing (``TIMING_STATS["reps"]`` unchanged) and
    gives the first table bit for bit, the stored key names the card, and
    the search on the cached table gives the fresh table's
    assignments."""
    import glob
    import shutil
    import tempfile

    from repro_torch.core import latency
    from repro_torch.core.spdy import search_family

    tmp = tempfile.mkdtemp(prefix="chip_smoke_latency_")
    try:
        def build():
            t0 = time.perf_counter()
            tab = latency.build_table(cfg, table.env, "measure",
                                      device="cuda", cache_dir=tmp,
                                      **LATENCY_KW)
            torch.cuda.synchronize()
            return tab, time.perf_counter() - t0, \
                latency.TIMING_STATS["reps"]

        reps0 = latency.TIMING_STATS["reps"]
        fresh, fresh_s, reps1 = build()
        hit, hit_s, reps2 = build()
        same = (fresh.base == hit.base and sorted(fresh.grids) ==
                sorted(hit.grids) and all(
                    (fresh.grids[k] == hit.grids[k]).all()
                    and (fresh.times[k] == hit.times[k]).all()
                    for k in fresh.grids))
        files = glob.glob(os.path.join(tmp, "lat_*.json"))
        with open(files[0]) as f:
            device = json.load(f)["key"]["device"]
        print(f"latency cache: fresh measurement {fresh_s:.4f} s "
              f"({reps1 - reps0} timed calls), hit {hit_s:.4f} s "
              f"({reps2 - reps1} timed calls), tables bit-equal: {same}, "
              f"{len(files)} file(s), stored device {device}")
        check(reps1 > reps0, "latency cache: the first build timed nothing")
        check(reps2 == reps1, "latency cache: the second build timed "
              "something (not a hit)")
        check(same, "latency cache: the cached table is not the fresh one")
        check(len(files) == 1 and device.get("name") ==
              torch.cuda.get_device_name(0)
              and device.get("capability") ==
              list(torch.cuda.get_device_capability(0)),
              f"latency cache: the stored key does not name the card "
              f"({device})")
        a = search_family(db, fresh, MAIN_TARGETS, steps=48, pop=16, seed=0)
        b = search_family(db, hit, MAIN_TARGETS, steps=48, pop=16, seed=0)
        for t in MAIN_TARGETS:
            check(a[t].assignment == b[t].assignment
                  and a[t].runtime == b[t].runtime,
                  f"latency cache: the search at {t}x differs on the "
                  "cached table")
        print(f"latency cache: the search's assignments on the cached "
              f"table are the fresh table's at {MAIN_TARGETS}")
        return {"fresh_s": fresh_s, "hit_s": hit_s}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def snapshots_within_f16(torch, a, b):
    """(levels bit-equal, largest difference over the levels that are
    not): every element of two float16 snapshot stacks within one float16
    rounding of either, checked on the card a level at a time."""
    equal, worst = 0, 0.0
    for i in range(a.shape[0]):
        if (a[i] == b[i]).all():
            equal += 1
            continue
        x = torch.from_numpy(a[i]).cuda().float()
        y = torch.from_numpy(b[i]).cuda().float()
        d = (x - y).abs()
        check(bool((d <= F16_ULP * torch.maximum(x.abs(), y.abs())
                    + F16_TINY).all()),
              f"compacted snapshot at level {i} differs by more than one "
              "float16 rounding")
        worst = max(worst, float(d.max()))
    return equal, worst


def run_compact_path(torch, kernels, cfg, params, calib):
    """Phase 16 (a): the plain and the live-set-compacted database of
    each module of phase 15's first self layer, at M = 1 (``build_module_db``,
    ``compact=False`` and ``True``), held to each other; the downdate's
    launches on the live prefix counted on the path; the kernel checked
    and timed at the first and last compacted FFN widths."""
    import numpy as np
    from repro_torch.core import database, obs
    from repro_torch.core.hessian import collect_hessians
    from repro_torch.core.structures import level_grid, registry
    from repro_torch.kernels import obs_downdate_plain

    t0 = time.perf_counter()
    hess = collect_hessians(cfg, params, calib, device="cuda")
    mods = [m for m in registry(cfg) if m.layer == 0]
    hess = {m.name: hess[m.name] for m in mods}
    torch.cuda.synchronize()
    print(f"compaction: Hessians of {cfg.name} ({cfg.num_layers} self "
          f"layers) in {time.perf_counter() - t0:.3f} s; modules "
          f"{[(m.name, m.n_structures, m.group_size) for m in mods]}")

    # instrumentation of this phase only: the downdate's calls with a live
    # prefix shorter than the working rows, and the compacted core's perm
    real_downdate, real_compact = obs.obs_downdate, \
        database.prune_structured_compact
    live = {"launches": 0, "widths": set()}
    perms = []

    def downdate(W, Hinv, *args, d_live=None):
        if d_live is not None and d_live < W.shape[1]:
            live["launches"] += 1
            live["widths"].add((W.shape[1], d_live))
        return real_downdate(W, Hinv, *args, d_live=d_live)

    def compact(*args, **kw):
        res = real_compact(*args, **kw)
        perms.append(res.perm.cpu().numpy())
        return res

    out = {}
    kernels.reset_launch_counts()
    obs.obs_downdate, database.prune_structured_compact = downdate, compact
    try:
        for mod in mods:
            lv = level_grid(mod)
            segs = obs._compaction_schedule(mod.n_structures, mod.group_size,
                                            max(lv), lv)
            runs = {}
            for route in ("plain", "compact"):
                before = kernels.obs_downdate.launches
                live_before = live["launches"]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                runs[route] = database.build_module_db(
                    cfg, params, mod, hess[mod.name],
                    compact=route == "compact")
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                n = kernels.obs_downdate.launches - before
                n_live = live["launches"] - live_before
                out[f"{mod.kind}_{route}_s"] = secs
                out[f"{mod.kind}_{route}_launches"] = n
                print(f"  {mod.name} {route}: {secs:.3f} s, {n} obs_downdate "
                      f"launches ({n_live} on a live prefix), "
                      f"{len(lv)} levels")
            plain, comp = runs["plain"], runs["compact"]
            perm = perms[-1]
            start, _, work_n, _ = segs[-1]
            equal, worst = snapshots_within_f16(torch, plain.snapshots,
                                                comp.snapshots)
            err = float(np.max(np.abs(comp.errors - plain.errors)
                               / np.maximum(np.abs(plain.errors), 1e-30)))
            print(f"  {mod.name}: {len(segs)} segments, working structures "
                  f"{[w for _, _, w, _ in segs]}; orders equal: "
                  f"{np.array_equal(plain.order, comp.order)}; errors "
                  f"within {err:.3e} relative; snapshot levels bit-equal "
                  f"{equal} of {len(lv)} (largest difference {worst:.3e}); "
                  f"perm {len(perm)} slots; compacted/plain seconds "
                  f"{out[f'{mod.kind}_compact_s'] / out[f'{mod.kind}_plain_s']:.4f}")
            check(len(segs) > 1, f"{mod.name}: the schedule never compacts")
            check(np.array_equal(plain.order, comp.order),
                  f"{mod.name}: compacted removal order differs")
            check(err <= 1e-5, f"{mod.name}: compacted errors differ by "
                  f"{err:.3e} relative")
            check(len(perm) == work_n and len(set(perm.tolist())) == work_n
                  and set(comp.order[start:].tolist()) <= set(perm.tolist()),
                  f"{mod.name}: the perm does not cover the live set")
            del runs, plain, comp
    finally:
        obs.obs_downdate, database.prune_structured_compact = \
            real_downdate, real_compact
    launches = {k.__name__: k.launches for k in kernels.KERNELS}
    print(f"compaction launches: {launches}; on a live prefix "
          f"{live['launches']} at (working rows, d_live) "
          f"{sorted(live['widths'])[:2]} ... {sorted(live['widths'])[-1:]}")
    for name in COMPACT_KERNELS:
        check(launches[name] > 0, f"{name} never launched on phase 16")
    check(live["launches"] > 0, "obs_downdate never launched with d_live "
          "below the working rows on phase 16")
    del hess
    torch.cuda.empty_cache()

    # the kernel at the first and the last compacted FFN widths
    ffn = next(m for m in mods if m.kind == "ffn")
    lv = level_grid(ffn)
    segs = obs._compaction_schedule(ffn.n_structures, 1, max(lv), lv)
    d_out = int(params["layers"]["ffn"]["wd"].shape[-1])
    g = torch.Generator(device="cuda").manual_seed(16)
    rows = []
    for _, _, work_n, live_n in (segs[1], segs[-1]):
        W = torch.randn((1, work_n, d_out), device="cuda", generator=g)
        H = torch.randn((1, work_n, work_n), device="cuda", generator=g)
        A = torch.randn((1, work_n, 1), device="cuda", generator=g)
        KW = torch.randn((1, 1, d_out), device="cuda", generator=g)
        KH = torch.randn((1, 1, work_n), device="cuda", generator=g)
        keep = (torch.rand((1, work_n), device="cuda",
                           generator=g) > 0.3).float()
        want = obs_downdate_plain(W, H, A, KW, KH, keep, live_n)
        got = kernels.obs_downdate(W.clone(), H.clone(), A, KW, KH, keep,
                                   live_n)
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        check(all(bool(torch.allclose(a, b, atol=1e-5, rtol=1e-5))
                  for a, b in zip(got, want)),
              f"obs_downdate disagrees at (1, {work_n}, {d_out}, 1) "
              f"d_live={live_n}")
        row = time_downdate(torch, kernels.obs_downdate, obs_downdate_plain,
                            W, H, A, KW, KH, keep, err, d_live=live_n)
        rows.append({"shape": [1, work_n, d_out, 1], "d_live": live_n,
                     **{key: row[key] for key in TIMED_KEYS}})
        del W, H, A, KW, KH, keep, want, got
    torch.cuda.empty_cache()
    return launches, out, rows


# phase 17: robustness on the card. Its parts run on phase 4's model,
# calibration, database and measured table and on phase 5's top member;
# (g) runs a gradual family on the first CHAOS_FAMILY_LAYERS layers with
# one target, 8 finetune steps of 4 x 256 and a checkpoint at step 4
# (keep_checkpoints=False, as phase 9), priced by the cost model, so the
# phase stays inside 60 s
CHAOS_REQUESTS = 4
CHAOS_FAMILY_LAYERS = 2
CHAOS_FAMILY_TARGETS = [1.3]
CHAOS_FAMILY_KW = {"finetune_steps": 8, "ckpt_every": 4, "search_steps": 8,
                   "search_pop": 8}
CHAOS_FAMILY_BATCH, CHAOS_FAMILY_SEQ = 4, 256
CHAOS_KERNELS = ONESHOT_KERNELS + SERVING_KERNELS

# injections and demotions counted while phase 17 is not running, in any
# report (the family engine's own included); check_reports fails on them
IN_CHAOS = [False]
OUTSIDE_CHAOS = []


def watch_reports() -> None:
    """Record every injection and demotion that a robustness report
    counts outside phase 17."""
    from repro_torch.robustness.report import RobustnessReport
    real = RobustnessReport.count

    def count(self, bucket, site, n=1):
        if bucket in ("injected", "demotions") and not IN_CHAOS[0]:
            OUTSIDE_CHAOS.append((bucket, site, n))
        return real(self, bucket, site, n)

    RobustnessReport.count = count


def check_reports() -> None:
    """After the last phase: the process's default report holds no
    injection, open breaker or demotion, and no report counted an
    injection or a demotion outside phase 17, so no cost-model table and
    no serial search stood in for a failure anywhere else."""
    from repro_torch.robustness import current_report
    rep = current_report().as_dict()
    print(f"robustness: default report {rep['counts']}, breakers open "
          f"{rep['breakers_open']}; injections and demotions outside "
          f"phase 17: {OUTSIDE_CHAOS}")
    check(not rep["counts"]["injected"] and not rep["breakers_open"]
          and not rep["counts"]["demotions"],
          f"the default robustness report is not clean: {rep}")
    check(not OUTSIDE_CHAOS, f"injections or demotions outside phase 17: "
          f"{OUTSIDE_CHAOS}")


def _same_db(a, b, names) -> bool:
    import numpy as np
    return all(np.array_equal(getattr(a[n], f), getattr(b[n], f))
               for n in names for f in ("order", "errors", "snapshots"))


def run_chaos_path(torch, kernels, cfg, params, calib, db, table, fam):
    """Phase 17: each robustness site on the card under its own plan and
    report scope (see the module docstring); returns the phase's
    launches."""
    import shutil
    import tempfile

    import numpy as np
    from repro_torch.checkpoint.manager import load_json
    from repro_torch.configs import GPT2_SMALL
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.database import SnapshotCache, build_database
    from repro_torch.core.hessian import collect_hessians
    from repro_torch.core.latency import (LatencyTable,
                                          build_costmodel_table, build_table)
    from repro_torch.core.latency_cache import LatencyCache
    from repro_torch.core.oneshot import (calib_loss_fn, make_batched_eval,
                                          oneshot_prune)
    from repro_torch.core.pipeline import (FamilyPreempted, family_run_dir,
                                           gradual_prune)
    from repro_torch.core.shrink import shrink_from_stitched
    from repro_torch.core.spdy import search_family
    from repro_torch.data import synthetic_stream
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.robustness import (FaultInjected, FaultPlan,
                                        RobustnessReport, damp_schedule,
                                        install, report_scope)
    from repro_torch.runtime.costmodel import H100_SXM, InferenceEnv
    from repro_torch.serve import (PrunedServeModel, ServeEngine,
                                   synthetic_requests)

    seconds = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_chaos_")
    IN_CHAOS[0] = True
    kernels.reset_launch_counts()

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        return out

    def faulted(spec):
        return install(FaultPlan.parse(spec)), report_scope()

    def counts(rep):
        return {b: d for b, d in rep.as_dict()["counts"].items() if d}

    try:
        # (a) a poisoned calibration batch is skipped
        def part_a():
            plan, scope = faulted("calib.batch:nan@1")
            with plan, scope as rep:
                got = collect_hessians(cfg, params, calib, device="cuda")
            clean = collect_hessians(cfg, params,
                                     [b for i, b in enumerate(calib)
                                      if i != 1], device="cuda")
            same = all(torch.equal(got[k], clean[k]) for k in clean)
            print(f"chaos (a) calib.batch:nan@1: Hessians bit-equal to a "
                  f"clean run without batch 1: {same}; {counts(rep)}")
            check(same, "chaos (a): the Hessians differ from the clean run "
                  "without the poisoned batch")
            check(counts(rep) == {
                "injected": {"calib.batch": 1}, "detected": {"calib.batch": 1},
                "recovered": {"calib.batch": 1}},
                f"chaos (a): counts {counts(rep)}")
            return collect_hessians(cfg, params, calib, device="cuda")

        hess = timed("a", part_a)

        # (b) a poisoned inverse Hessian heals on the damping ladder
        def part_b():
            plan, scope = faulted("obs.cholesky:nan@0")
            with plan, scope as rep:
                got = build_database(cfg, params, hess, device="cuda")
            rung1 = build_database(cfg, params, hess,
                                   damp=damp_schedule(1e-4)[1],
                                   device="cuda")
            attn = [n for n in db if db[n].mod.kind == "attn"]
            ffn = [n for n in db if db[n].mod.kind != "attn"]
            healed, kept = _same_db(got, rung1, attn), _same_db(got, db, ffn)
            print(f"chaos (b) obs.cholesky:nan@0: the attention chunk equals "
                  f"a clean build at damp {damp_schedule(1e-4)[1]:g}: "
                  f"{healed}, the FFN chunk phase 4's database: {kept}; "
                  f"{counts(rep)}")
            check(healed and kept, "chaos (b): the healed database differs")
            check(counts(rep) == {
                "injected": {"obs.cholesky": 1},
                "detected": {"obs.cholesky": 1},
                "retries": {"obs.cholesky": 1},
                "recovered": {"obs.cholesky": 1}},
                f"chaos (b): counts {counts(rep)}")

        timed("b", part_b)
        del hess

        # (c) an injected kernel failure raises; nothing falls back
        def part_c():
            before = {k.__name__: k.launches for k in kernels.KERNELS}
            plan, scope = faulted("kernel.pallas:raise@0")
            raised = None
            with plan, scope as rep:
                try:
                    oneshot_prune(cfg, params, calib, table.env, MAIN_TARGETS,
                                  latency_backend="measure",
                                  latency_kw=LATENCY_KW, search_steps=48,
                                  search_pop=16, seed=0, device="cuda")
                except FaultInjected as e:
                    raised = e
            after = {k.__name__: k.launches for k in kernels.KERNELS}
            print(f"chaos (c) kernel.pallas:raise@0: oneshot_prune raised "
                  f"{raised!r}; launches unchanged: {after == before}; "
                  f"{counts(rep)}, breakers {rep.as_dict()['breakers_open']}")
            check(raised is not None, "chaos (c): oneshot_prune did not "
                  "raise the injected kernel failure")
            check(after == before and not rep.as_dict()["breakers_open"]
                  and counts(rep) == {"injected": {"kernel.pallas": 1}},
                  "chaos (c): a kernel failure was counted, launched or "
                  "demoted")

        timed("c", part_c)

        # (d) a failed batched scorer demotes the search to serial scoring
        cache = SnapshotCache(cfg, db, device="cuda")

        def part_d():
            loss = calib_loss_fn(cfg, calib[:1], device="cuda")
            kw = dict(steps=48, pop=16, seed=0,
                      eval_fn=lambda a: loss(cache.apply(params, a)),
                      eval_batched=make_batched_eval(cfg, params, cache,
                                                     calib[:1],
                                                     device="cuda"))
            t0 = time.perf_counter()
            clean = search_family(db, table, MAIN_TARGETS, **kw)
            seconds["d_clean"] = time.perf_counter() - t0
            plan, scope = faulted("spdy.batched_eval:raise@0")
            with plan, scope as rep:
                got = search_family(db, table, MAIN_TARGETS, **kw)
            same = {t: got[t].assignment == clean[t].assignment
                    and got[t].score == clean[t].score for t in MAIN_TARGETS}
            print(f"chaos (d) spdy.batched_eval:raise@0: the serial search "
                  f"equals the clean batched one {same}; {counts(rep)}")
            check(all(same.values()), "chaos (d): the demoted search differs")
            check(rep.counts["demotions"] == {"spdy.batched_eval": 1},
                  f"chaos (d): counts {counts(rep)}")

        timed("d", part_d)

        # (e) a failed measurement demotes the table to the cost model
        def part_e():
            env = table.env.replace(hw=H100_SXM)
            path = LatencyCache(tmp).put(
                cfg, env, LatencyTable(env=env, grids=table.grids,
                                       times=table.times, base=table.base),
                "cuda", **LATENCY_KW)
            plan, scope = faulted("latency.measure:raise@0")
            with plan, scope as rep:
                got = build_table(cfg, env, "measure", device="cuda",
                                  cache_dir=tmp, refresh=True, **LATENCY_KW)
            want = build_costmodel_table(cfg, env)
            same = got.base == want.base and sorted(got.times) == sorted(
                want.times) and all(np.array_equal(got.times[k],
                                                   want.times[k])
                                    for k in want.times)
            moved = not os.path.exists(path) and os.path.exists(
                path + ".corrupt")
            print(f"chaos (e) latency.measure:raise@0: the cost-model table "
                  f"on {H100_SXM.name}: {same}, the cached entry "
                  f"quarantined: {moved}; {counts(rep)}")
            check(same and moved, "chaos (e): no cost-model table or no "
                  "quarantine")
            check(rep.counts["demotions"] == {"latency.measure": 1},
                  f"chaos (e): counts {counts(rep)}")

        timed("e", part_e)

        # (f) failed decode steps are recomputed
        def part_f():
            t = max(fam)
            a = fam[t].assignment
            pm = shrink_from_stitched(cfg.replace(dtype="float32"),
                                      cache.apply(params, a), db, a)
            reqs = synthetic_requests(cfg, CHAOS_REQUESTS, **STREAM)

            def serve():
                eng = ServeEngine(PrunedServeModel(pm, SERVE["max_len"]),
                                  SERVE["slots"])
                return [r.tokens for r in eng.run(reqs).records]

            clean = serve()
            plan, scope = faulted("serve.step:nan@2,serve.step:raise@5")
            with plan, scope as rep:
                got = serve()
            print(f"chaos (f) serve.step:nan@2,serve.step:raise@5 on the "
                  f"{t}x member (fp32, {CHAOS_REQUESTS} requests, "
                  f"{sum(map(len, clean))} tokens): the clean tokens "
                  f"{got == clean}; {counts(rep)}")
            check(got == clean, "chaos (f): recomputed steps changed the "
                  "tokens")
            check(rep.counts["detected"] == {"serve.step": 2}
                  and rep.counts["recovered"] == {"serve.step": 2},
                  f"chaos (f): counts {counts(rep)}")

        timed("f", part_f)
        del cache
        torch.cuda.empty_cache()

        # (g) a corrupted artifact and failed checkpoint writes heal
        def part_g():
            L = CHAOS_FAMILY_LAYERS
            cfg2 = GPT2_SMALL.replace(num_layers=L)
            p2 = {**params, "layers": {
                grp: {k: t[:L] for k, t in sub.items()}
                for grp, sub in params["layers"].items()}}
            env = InferenceEnv(hw=H100_SXM, **FAMILY_ENV)
            tcfg = TrainConfig(**{**FAMILY_TRAIN, "total_steps":
                                  CHAOS_FAMILY_KW["finetune_steps"]})

            def run(name, **kw):
                return gradual_prune(
                    cfg2, p2, env, CHAOS_FAMILY_TARGETS,
                    lambda step: synthetic_stream(
                        cfg2, CHAOS_FAMILY_BATCH, CHAOS_FAMILY_SEQ, seed=0,
                        start_step=step),
                    calib, tcfg=tcfg, ckpt_dir=os.path.join(tmp, name),
                    seed=0, keep_checkpoints=False, device="cuda",
                    **CHAOS_FAMILY_KW, **kw)

            t0 = time.perf_counter()
            clean = run("clean")
            seconds["g_clean"] = time.perf_counter() - t0
            man = load_json(os.path.join(family_run_dir(
                cfg2, CHAOS_FAMILY_TARGETS, 0, os.path.join(tmp, "clean")),
                "family.json"))
            print("chaos (g) clean run stage seconds " + json.dumps(
                {t: {k: round(v, 4) for k, v in e["stage_times"].items()}
                 for t, e in man["targets"].items()}))
            plan = FaultPlan.parse("db.artifact_write:corrupt@0,"
                                   "ckpt.async_write:oserror@0x2")
            rep = RobustnessReport()
            stopped = False
            with install(plan):
                try:
                    run("faulted", stop_after=(0, "hessians"))
                except FamilyPreempted:
                    stopped = True
                got = run("faulted", report=rep)
            same = all(
                a.assignment == b.assignment
                and a.loss_after_ft == b.loss_after_ft and all(
                    torch.equal(x, y) for x, y in zip(tree_leaves(a.params),
                                                      tree_leaves(b.params)))
                for a, b in zip(clean, got))
            quarantined = [os.path.basename(q) for q in rep.quarantined]
            achieved = [round(float(v.achieved), 4) for v in got]
            print(f"chaos (g) {cfg2.name} family {CHAOS_FAMILY_TARGETS} "
                  f"({CHAOS_FAMILY_KW}): killed after its Hessians "
                  f"{stopped}, resumed bit-equal to the clean run: {same}; "
                  f"achieved {achieved}x; fired {plan.fired}; quarantined "
                  f"{quarantined}; {counts(rep)}")
            check(stopped and same, "chaos (g): the healed family differs "
                  "from the clean run")
            check(quarantined == ["hessians.npz.corrupt"]
                  and rep.counts["recovered"] == {"ckpt.async_write": 1}
                  and rep.counts["retries"] == {"ckpt.async_write": 2},
                  f"chaos (g): counts {counts(rep)}, quarantined "
                  f"{quarantined}")

        timed("g", part_g)
    finally:
        IN_CHAOS[0] = False
        shutil.rmtree(tmp, ignore_errors=True)
    launches = {k.__name__: k.launches for k in kernels.KERNELS}
    print("chaos seconds: " + json.dumps(
        {k: round(v, 4) for k, v in seconds.items()}))
    print("chaos_launches: " + json.dumps(launches))
    for name in CHAOS_KERNELS:
        check(launches[name] > 0, f"{name} never launched on phase 17")
    return launches


# phase 18: two ranks on the card, gloo groups; a rank's collectives and
# the launch time out (a hung rank costs this much of the 1200 s at most)
SHARDED_RANKS = 2
SHARDED_TIMEOUT = 240
SHARDED_KERNELS = ONESHOT_KERNELS
SHARDED_SEARCH = {"search_steps": 48, "search_pop": 16, "seed": 0}
# (f) and (g): the mesh trainer on phase 4's model, 6 steps of 8 x 256
# tokens in 2 microbatches, distilled (logit 1.0, token 0.5) from a
# second seeded draw, fp32 then int8_ef. (f) keeps the reference's
# bounds (params within 1e-4 of the parent's single-process trainer,
# each step's loss within 1e-3 of the single-process loss of the same
# params and batch), but at this learning rate the whole update is
# about 1e-6 a weight, so the params bound cannot see a wrong update:
# (f) is also held to what grows with the work, each limit set between
# the sound run's largest reading and the nearest planted fault's
# (scripts/sweep_torch_mesh_lr.py --plant, on an NVIDIA H100 80GB HBM3
# at 700 W; PERF.md, section 6): the trajectories' largest loss gap
# (sound 1.05e-2; faults 0.554 and up), each step's gradient norm
# relative to the parent's (sound 9.6e-5; no update 9.4e-3, half the
# batch 0.136, gradients not all-reduced 0.44), and the update
# |d_mesh - d_one| / |d_one| over the rank's slices (sound 9.9e-3;
# faults 0.419 and up). (g)'s last loss stays within 0.15 of (f)'s.
# The learning rate: at this model's loss (about 1400, against about 46
# at the reference test's width) the int8 run's last loss fell within
# 0.15 of fp32's only at 3e-7 and below (at 1e-6 0.163), and the loss
# still falls 4.6 more over the 6 steps than at 1e-7
MESH_TRAIN = {"learning_rate": 3e-7, "warmup_steps": 2, "total_steps": 6,
              "microbatches": 2, "distill_logit": 1.0, "distill_token": 0.5}
MESH_TRAIN_BATCH, MESH_TRAIN_SEQ = 8, 256
MESH_TEACHER_SEED = 1
MESH_PARAMS_TOL, MESH_LOSS_TOL, INT8_LOSS_GAP = 1e-4, 1e-3, 0.15
MESH_PATH_GAP, MESH_GRAD_REL, MESH_UPDATE_REL = 0.1, 1e-3, 0.05
# (h): gradual_prune(mesh=, specs=) as phase 17 (g): the first 2 layers,
# one target on the cost model, 8 finetune steps of 4 x 256, killed at
# step 4 and resumed
MESH_FAMILY_STOP = (0, "finetune", 4)
# each rank imports this file and runs sharded_rank (ROOT and WORK are
# prepended)
SHARDED_SCRIPT = """
import sys

sys.path.insert(0, ROOT)
import chip_smoke

chip_smoke.sharded_rank(WORK)
"""


def leaf_digests(params, calib):
    """sha256 of each weight (by its path) and of the tokens."""
    import hashlib

    def walk(tree, path):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from walk(v, f"{path}/{k}")
        else:
            yield path, tree

    out = {"tokens": hashlib.sha256(b"".join(
        b["tokens"].numpy().tobytes() for b in calib)).hexdigest()}
    for path, t in walk(params, ""):
        out[path] = hashlib.sha256(
            t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()
    return out


def db_digests(db):
    """Per module: its removal order and errors (lists) and the sha256 of
    its float16 snapshots."""
    import hashlib
    return {n: {"order": m.order.tolist(), "errors": m.errors.tolist(),
                "snapshots": hashlib.sha256(m.snapshots.tobytes()).hexdigest()}
            for n, m in db.items()}


def family_of(res):
    """Per target: the assignment, speedup, search score, history and
    ``n_evals``."""
    return {str(t): [v.assignment, v.speedup, v.search.score,
                     v.search.history, v.search.n_evals]
            for t, v in res.variants.items()}


def audit_writes(root: str, log: list):
    """A context in which every Python-level write under ``root`` (an
    ``open`` for writing, a rename, replace, remove, directory creation
    or removal) appends its path to ``log``."""
    import builtins
    import contextlib
    import io
    import shutil

    root = os.path.abspath(root)

    def note(path):
        path = os.path.abspath(os.fsdecode(path))
        if path.startswith(root):
            log.append(path)

    @contextlib.contextmanager
    def ctx():
        saved = [(builtins, "open"), (io, "open"), (shutil, "rmtree")] + [
            (os, n) for n in ("replace", "rename", "remove", "unlink",
                              "makedirs", "mkdir", "rmdir")]
        real = {(m, n): getattr(m, n) for m, n in saved}

        def opener(f, mode="r", *a, **k):
            if isinstance(f, (str, bytes, os.PathLike)) and any(
                    c in mode for c in "wax+"):
                note(f)
            return real[(builtins, "open")](f, mode, *a, **k)

        def wrap(fn):
            def call(path, *a, **k):
                note(path)
                return fn(path, *a, **k)
            return call

        try:
            builtins.open = io.open = opener
            for m, n in saved[2:]:
                setattr(m, n, wrap(real[(m, n)]))
            yield log
        finally:
            for (m, n), fn in real.items():
                setattr(m, n, fn)

    return ctx()


def staged_since(mesh, before):
    """Per collective, [calls, bytes, seconds] since the snapshot
    ``before`` of ``mesh.staged``."""
    return {k: [v[0] - before.get(k, [0, 0, 0.0])[0],
                v[1] - before.get(k, [0, 0, 0.0])[1],
                round(v[2] - before.get(k, [0, 0, 0.0])[2], 4)]
            for k, v in mesh.staged.items()}


def mesh_train_setup(torch):
    """(f) and (g)'s teacher (the second seeded draw) and TrainConfig."""
    from repro_torch.configs import GPT2_SMALL
    from repro_torch.configs.base import TrainConfig
    from repro_torch.models import model_init

    cfg = GPT2_SMALL.replace(num_layers=MAIN_LAYERS)
    teacher = model_init(cfg, torch.Generator().manual_seed(
        MESH_TEACHER_SEED), device="cuda")
    return teacher, TrainConfig(**MESH_TRAIN)


def mesh_train_data(cfg):
    from repro_torch.data import synthetic_stream
    return synthetic_stream(cfg, MESH_TRAIN_BATCH, MESH_TRAIN_SEQ, seed=3)


def mesh_family_cfg():
    from repro_torch.configs import GPT2_SMALL
    return GPT2_SMALL.replace(num_layers=CHAOS_FAMILY_LAYERS)


def mesh_family(torch, params, calib, ckpt_dir, **kw):
    """(h)'s family: phase 17 (g)'s, over ``kw``'s mesh and specs."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.pipeline import gradual_prune
    from repro_torch.data import synthetic_stream
    from repro_torch.runtime.costmodel import H100_SXM, InferenceEnv

    cfg2, L = mesh_family_cfg(), CHAOS_FAMILY_LAYERS
    p2 = {**params, "layers": {grp: {k: t[:L] for k, t in sub.items()}
                               for grp, sub in params["layers"].items()}}
    tcfg = TrainConfig(**{**FAMILY_TRAIN, "total_steps":
                          CHAOS_FAMILY_KW["finetune_steps"]})
    return gradual_prune(
        cfg2, p2, InferenceEnv(hw=H100_SXM, **FAMILY_ENV),
        CHAOS_FAMILY_TARGETS,
        lambda step: synthetic_stream(cfg2, CHAOS_FAMILY_BATCH,
                                      CHAOS_FAMILY_SEQ, seed=0,
                                      start_step=step),
        calib, tcfg=tcfg, ckpt_dir=ckpt_dir, seed=0, keep_checkpoints=False,
        device="cuda", **CHAOS_FAMILY_KW, **kw)


def family_digest(fam):
    """sha256 of a family's targets, speedups, assignments, losses and
    params' bits."""
    import hashlib
    h = hashlib.sha256()
    for v in fam:
        h.update(json.dumps([v.target, v.achieved, v.assignment,
                             v.loss_before_ft, v.loss_after_ft]).encode())
        for _, t in tree_paths(v.params):
            h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def tree_paths(tree, prefix=""):
    """(path, leaf) of a tree of dicts, keys sorted; a spec (a tuple) is
    a leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_paths(tree[k], f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def mesh_update_gap(torch, got, one, init, specs, mesh):
    """(f)'s params against the single-process trainer's on this rank's
    slices: the largest absolute difference, and ``[|d_mesh - d_one|^2,
    |d_one|^2]`` where ``d`` is the change from the whole ``init``
    params (float64 sums). ``got``: the rank's slices; ``one``: the
    whole final params by path (an ``np.load``); ``specs``: the params'
    specs."""
    from repro_torch.distributed import shard_of

    specs = dict(tree_paths(specs))
    start = dict(tree_paths(init))
    diff, sums = 0.0, [0.0, 0.0]
    for k, g in tree_paths(got):
        o = shard_of(torch.from_numpy(one[k]), specs[k], mesh).to(g.device)
        s = shard_of(start[k], specs[k], mesh)
        diff = max(diff, float((g - o).abs().max()))
        o, g, s = o.double(), g.double(), s.double()
        sums[0] += float(((g - o) ** 2).sum())
        sums[1] += float(((o - s) ** 2).sum())
    return diff, sums


def update_rel(sums) -> float:
    """``|d_mesh - d_one| / |d_one|`` from ``mesh_update_gap``'s sums."""
    return (sums[0] / sums[1]) ** 0.5 if sums[1] > 0 else float("inf")


def grad_norm_gaps(mesh_norms, one_norms):
    """Each step's relative difference of the mesh trainer's gradient
    norm from the single-process trainer's."""
    return [abs(a - b) / b for a, b in zip(mesh_norms, one_norms)]


def run_mesh_parts(torch, cfg, params, calib, mesh, work, out, timed,
                   teacher, tcfg):
    """Phase 18 (f)-(h) on this rank (see the module docstring), with
    ``mesh_train_setup``'s teacher and TrainConfig."""
    import dataclasses

    import numpy as np
    from repro_torch import kernels
    from repro_torch.checkpoint.manager import load_json
    from repro_torch.core.pipeline import FamilyPreempted, family_run_dir
    from repro_torch.distill.losses import distillation_loss
    from repro_torch.distributed import axis_size
    from repro_torch.models import model_specs, param_shapes
    from repro_torch.train import Trainer

    steps = MESH_TRAIN["total_steps"]

    def trainer(name, compression):
        return Trainer(cfg, dataclasses.replace(
            tcfg, grad_compression=compression),
            ckpt_dir=os.path.join(work, name), ckpt_every=100, log_every=1,
            teacher_params=teacher, mesh=mesh, specs=model_specs(cfg),
            device="cuda")

    def holds_its_slices(tr, st):
        """Each leaf of params, m and v is this rank's slice only."""
        whole = dict(tree_paths(param_shapes(cfg)))
        specs = dict(tree_paths(tr._st_sh.params))
        want = {k: tuple(d // axis_size(mesh, a) for d, a in
                         zip(w, specs[k] + (None,) * len(w)))
                for k, w in whole.items()}
        got = [{k: tuple(x.shape) for k, x in tree_paths(t)}
               for t in (st.params, st.opt["m"], st.opt["v"])]
        return all(g == want for g in got) and bool(sum(
            np.prod(w) for w in want.values()) < sum(
            np.prod(w) for w in whole.values()))

    def part_f():
        tr = trainer("f", "none")
        st = tr.init_or_restore(params)
        data, same = mesh_train_data(cfg), mesh_train_data(cfg)
        one_step = []
        for k in range(steps):
            # the single-process loss of the params and batch this step
            # takes: the mean over its microbatches, as the step's
            batch = {key: v.cuda() for key, v in next(same).items()}
            whole = tr.params_of(st) if k else params
            n = batch["tokens"].shape[0] // MESH_TRAIN["microbatches"]
            with torch.no_grad():
                one_step.append(float(torch.stack([distillation_loss(
                    cfg, whole, teacher,
                    {key: v[i * n:(i + 1) * n] for key, v in batch.items()},
                    l_logit=MESH_TRAIN["distill_logit"],
                    l_token=MESH_TRAIN["distill_token"])[0]
                    for i in range(MESH_TRAIN["microbatches"])]).mean(0)))
            del whole, batch
            st = tr.fit(st, data, steps=k + 1, save_last=False)
        torch.cuda.synchronize()
        out["f_one_step"] = one_step
        out["f_losses"] = [m["loss"] for m in tr.metrics_log]
        out["f_kl"] = [m["logit_kl"] for m in tr.metrics_log]
        out["f_grad_norms"] = [m["grad_norm"] for m in tr.metrics_log]
        out["f_step_s"] = [m["step_time"] for m in tr.metrics_log]
        out["f_slices"] = holds_its_slices(tr, st)
        with np.load(wait_for(os.path.join(work, "fp32_params.npz"))) as f:
            out["f_params_diff"], out["f_update"] = mesh_update_gap(
                torch, st.params, f, params, tr._st_sh.params, mesh)
        tr.ckpt.close()

    timed("f", part_f)

    def part_g():
        tr = trainer("g", "int8_ef")
        st = tr.init_or_restore(params)
        data = mesh_train_data(cfg)
        rows, nonzero, changed = set(), [], []
        for k in range(steps):
            prev = [e.clone() for _, e in tree_paths(st.ef_err)]
            st = tr.fit(st, data, steps=k + 1, save_last=False)
            now = [e for _, e in tree_paths(st.ef_err)]
            rows |= {int(e.shape[0]) for e in now}
            nonzero.append(any(bool((e != 0).any()) for e in now))
            changed.append(any(not torch.equal(a, b)
                               for a, b in zip(prev, now)))
            del prev
        torch.cuda.synchronize()
        out["g_rows"] = sorted(rows)
        out["g_nonzero"], out["g_changed"] = nonzero, changed
        out["g_losses"] = [m["loss"] for m in tr.metrics_log]
        out["g_step_s"] = [m["step_time"] for m in tr.metrics_log]
        tr.ckpt.close()

    timed("g", part_g)
    del teacher
    torch.cuda.empty_cache()

    def part_h():
        snap = {k.__name__: k.launches for k in kernels.KERNELS}
        root = os.path.join(work, "family")
        kw = dict(mesh=mesh, specs=model_specs(mesh_family_cfg()))
        writes = []
        with audit_writes(root, writes):
            a = mesh_family(torch, params, calib, os.path.join(root, "a"),
                            **kw)
            try:
                mesh_family(torch, params, calib, os.path.join(root, "b"),
                            stop_after=MESH_FAMILY_STOP, **kw)
                out["h_killed"] = False
            except FamilyPreempted:
                out["h_killed"] = True
            b = mesh_family(torch, params, calib, os.path.join(root, "b"),
                            **kw)
        torch.cuda.synchronize()
        out["h_launches"] = {k.__name__: k.launches - snap[k.__name__]
                             for k in kernels.KERNELS}
        out["h_writes"] = len(writes)
        out["h_digest"] = [family_digest(a), family_digest(b)]
        out["h_assignment"] = [a[0].assignment, b[0].assignment]
        out["h_achieved"] = [a[0].achieved, b[0].achieved]
        out["h_shas"] = [{t: {k: v for k, v in e.items()
                              if k.endswith("sha256")}
                          for t, e in load_json(os.path.join(family_run_dir(
                              mesh_family_cfg(), CHAOS_FAMILY_TARGETS, 0,
                              os.path.join(root, name)), "family.json")
                          )["targets"].items()} for name in ("a", "b")]

    timed("h", part_h)


def sharded_env():
    from repro_torch.runtime.costmodel import H100_SXM, InferenceEnv
    return InferenceEnv(batch=16, seq=128, mode="prefill", hw=H100_SXM)


def wait_for(path: str) -> str:
    """``path`` once it exists (the parent renames each file it hands the
    ranks into place whole), within the phase's timeout."""
    deadline = time.monotonic() + SHARDED_TIMEOUT
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"the parent never wrote {path}")
        time.sleep(0.05)
    return path


def sharded_rank(work: str) -> None:
    """Phase 18's rank program (both ranks): phase 4's model rebuilt,
    then (a)-(h) over a 2-rank mesh; prints the rank's RESULT line."""
    import threading

    import numpy as np
    import torch
    from repro_torch.launch.subproc import emit_result, init_rank

    rank, world, _ = init_rank(timeout=SHARDED_TIMEOUT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch import kernels
    from repro_torch.core import spdy
    from repro_torch.core.database import build_database
    from repro_torch.core.hessian import collect_hessians
    from repro_torch.core.oneshot import oneshot_prune
    from repro_torch.distributed import make_mesh
    from repro_torch.robustness import FaultPlan, install, report_scope

    t0 = time.perf_counter()
    cfg, params, calib = main_model(torch)
    out = {"rank": rank, "leaves": leaf_digests(params, calib),
           "seconds": {}}
    mesh = make_mesh((world,), ("data",))
    with np.load(wait_for(os.path.join(work, "hessians.npz"))) as f:
        clean = {k: torch.from_numpy(f[k]).cuda() for k in f.files}
    with open(wait_for(os.path.join(work, "phase4_db.json"))) as f:
        phase4 = json.load(f)
    out["seconds"]["setup"] = time.perf_counter() - t0
    # beside (a)-(e), which wait on the card and the collectives: the
    # import that a process's first torch.use_deterministic_algorithms
    # call makes (torch._inductor's config; 7.0 s of a first train
    # step's 8.5 s on an NVIDIA H100 80GB HBM3's host,
    # scripts/probe_torch_first_step.py), then (f)'s teacher drawn
    teacher = {}

    def prepare():
        import importlib
        importlib.import_module("torch._inductor.config")
        teacher.update(zip(("params", "tcfg"), mesh_train_setup(torch)))

    drawing = threading.Thread(target=prepare)
    drawing.start()

    out["staged"] = {}

    def timed(part, fn):
        before = {k: list(v) for k, v in mesh.staged.items()}
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        out["seconds"][part] = time.perf_counter() - t0
        out["staged"][part] = staged_since(mesh, before)
        return got

    kernels.reset_launch_counts()
    hess = timed("a", lambda: collect_hessians(cfg, params, calib,
                                               mesh=mesh, device="cuda"))
    out["a_keys"] = list(hess) == list(clean)
    out["a_rel"] = max(float((hess[k] - clean[k]).abs().max()
                             / clean[k].abs().max()) for k in clean)
    db = timed("b", lambda: build_database(cfg, params, clean, mesh=mesh,
                                           device="cuda"))
    got = db_digests(db)
    out["b_orders"] = all(got[n]["order"] == phase4[n]["order"]
                          for n in phase4)
    out["b_errors_rel"] = max(float(np.max(
        np.abs(np.subtract(got[n]["errors"], phase4[n]["errors"]))
        / np.maximum(np.abs(phase4[n]["errors"]), 1e-30))) for n in phase4)
    out["b_exact"] = got == phase4
    with install(FaultPlan.parse("db.sharded_group:raise@0")) as plan, \
            report_scope() as rep:
        db_c = timed("c", lambda: build_database(
            cfg, params, clean, mesh=mesh, device="cuda"))
    out["c_exact"] = _same_db(db_c, db, list(db))
    out["c_counts"] = {b: d for b, d in rep.as_dict()["counts"].items() if d}
    out["c_breaker"] = rep.breaker_open("db.sharded_group")
    out["c_hits"] = plan.hits.get("db.sharded_group")
    del db, db_c
    # (d) the placed loss-scored search, (e) under a scorer fault on rank
    # 0 only; both fed the parent's Hessians, as (b) is
    for part, rule in (("d", None), ("e", "spdy.batched_eval:raise@0")):
        plan = FaultPlan.parse(rule) if rule and rank == 0 else None
        spdy.reset_placed_scoring()
        with install(plan), report_scope() as rep:
            res = timed(part, lambda: oneshot_prune(
                cfg, params, calib, sharded_env(), MAIN_TARGETS, mesh=mesh,
                hessians=clean, device="cuda", **SHARDED_SEARCH))
        out[part] = family_of(res)
        out[part + "_scoring"] = dict(spdy.PLACED_SCORING)
        out[part + "_counts"] = {b: d for b, d in
                                 rep.as_dict()["counts"].items() if d}
        out[part + "_search_s"] = res.stage_seconds["search"]
        del res
    # (f)-(h) the mesh trainer and the family over the ranks
    drawing.join()
    run_mesh_parts(torch, cfg, params, calib, mesh, work, out, timed,
                   teacher["params"], teacher["tcfg"])
    out["launches"] = {k.__name__: k.launches for k in kernels.KERNELS}
    emit_result(out)


def single_process_trainer(torch, cfg, params, work):
    """(f)'s reference in the parent: the single-process trainer on the
    same weights, teacher and batches; its final params go to
    ``work/fp32_params.npz`` for the ranks (renamed into place whole),
    its losses are returned."""
    import numpy as np
    from repro_torch.train import Trainer

    teacher, tcfg = mesh_train_setup(torch)
    tr = Trainer(cfg, tcfg, ckpt_dir=os.path.join(work, "one"),
                 ckpt_every=100, log_every=1, teacher_params=teacher,
                 device="cuda")
    st = tr.fit(tr.init_or_restore(params), mesh_train_data(cfg),
                steps=MESH_TRAIN["total_steps"], save_last=False)
    tr.ckpt.close()
    path = os.path.join(work, "fp32_params.npz")
    with open(path + ".tmp", "wb") as f:  # the ranks wait for the name
        np.savez(f, **{k: t.cpu().numpy() for k, t in tree_paths(st.params)})
    os.replace(path + ".tmp", path)
    return {"losses": [m["loss"] for m in tr.metrics_log],
            "grad_norms": [m["grad_norm"] for m in tr.metrics_log],
            "step_s": [m["step_time"] for m in tr.metrics_log]}


def check_mesh_parts(ranks, one):
    """Phase 18 (f)-(h)'s checks on every rank's RESULT (module
    docstring)."""
    print(f"  parent (f): single-process losses {one['losses']}, gradient "
          f"norms {one['grad_norms']}, step "
          f"seconds {[round(t, 4) for t in one['step_s']]}")
    for r in ranks:
        rank = r["rank"]
        f_gap = max(abs(a - b) for a, b in zip(r["f_losses"],
                                               r["f_one_step"]))
        path_gap = max(abs(a - b) for a, b in zip(r["f_losses"],
                                                  one["losses"]))
        grad_rel = max(grad_norm_gaps(r["f_grad_norms"],
                                      one["grad_norms"]))
        upd_rel = update_rel(r["f_update"])
        print(f"  rank {rank} (f): losses {r['f_losses']}, max gap to the "
              f"single-process loss of the same params and batch "
              f"{f_gap:.3e}, to the parent's trajectory {path_gap:.3e}, "
              f"params max diff {r['f_params_diff']:.3e}, gradient norms "
              f"{r['f_grad_norms']} (largest relative gap {grad_rel:.3e}), "
              f"update relative gap {upd_rel:.4e}, "
              f"logit_kl {[round(k, 4) for k in r['f_kl']]}, its slices "
              f"only {r['f_slices']}, step seconds "
              f"{[round(t, 4) for t in r['f_step_s']]}")
        print(f"  rank {rank} (g): losses {r['g_losses']}, residual rows "
              f"{r['g_rows']}, nonzero {r['g_nonzero']}, changed "
              f"{r['g_changed']}, step seconds "
              f"{[round(t, 4) for t in r['g_step_s']]}")
        print(f"  rank {rank} (h): killed {r['h_killed']}, digests "
              f"{r['h_digest']}, achieved {r['h_achieved']}, assignment "
              f"{r['h_assignment'][0]}, writes under the run directories "
              f"{r['h_writes']}, launches {r['h_launches']}")
        print(f"  rank {rank} staged [calls, bytes, seconds] by part: "
              + json.dumps(r["staged"]))
        check(len(r["f_losses"]) == len(one["losses"])
              == MESH_TRAIN["total_steps"] and f_gap < MESH_LOSS_TOL
              and r["f_params_diff"] < MESH_PARAMS_TOL,
              f"sharded (f) rank {rank}: the mesh trainer is {f_gap:.3e} "
              f"from the single-process losses and "
              f"{r['f_params_diff']:.3e} from its params")
        check(path_gap < MESH_PATH_GAP and grad_rel < MESH_GRAD_REL
              and upd_rel < MESH_UPDATE_REL,
              f"sharded (f) rank {rank}: the mesh trainer's trajectory is "
              f"{path_gap:.3e} from the parent's in loss, its gradient norms "
              f"{grad_rel:.3e} and its update {upd_rel:.4e} relative")
        check(all(k > 0 for k in r["f_kl"]) and r["f_slices"],
              f"sharded (f) rank {rank}: logit_kl {r['f_kl']}, its slices "
              f"only {r['f_slices']}")
        check(r["g_rows"] == [1] and all(r["g_nonzero"])
              and all(r["g_changed"])
              and abs(r["g_losses"][-1] - r["f_losses"][-1]) < INT8_LOSS_GAP,
              f"sharded (g) rank {rank}: rows {r['g_rows']}, nonzero "
              f"{r['g_nonzero']}, changed {r['g_changed']}, last loss "
              f"{r['g_losses'][-1]} against (f)'s {r['f_losses'][-1]}")
        check(r["h_killed"] and r["h_digest"][0] == r["h_digest"][1]
              and r["h_assignment"][0] == r["h_assignment"][1]
              and r["h_shas"][0] == r["h_shas"][1],
              f"sharded (h) rank {rank}: the resumed family differs from "
              "the uninterrupted one")
        check(all(r["h_launches"][k] > 0 for k in SHARDED_KERNELS),
              f"sharded (h) rank {rank}: launches {r['h_launches']}")
        check((r["h_writes"] > 0) == (rank == 0),
              f"sharded (h) rank {rank}: {r['h_writes']} writes under the "
              "run directories (the first rank alone writes)")
    check(len({r["h_digest"][0] for r in ranks}) == 1
          and len({json.dumps(r["f_losses"]) for r in ranks}) == 1,
          "sharded (f)/(h): the ranks' results differ")


def run_sharded_path(torch, cfg, params, calib, db):
    """Phase 18: phase 4's model, calibration and database against two
    ranks on the card (see the module docstring); returns each rank's
    launches."""
    import shutil
    import tempfile
    import threading

    import numpy as np
    from repro_torch.core.hessian import collect_hessians
    from repro_torch.core.oneshot import oneshot_prune
    from repro_torch.launch.subproc import run_ranks

    seconds = {}
    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_sharded_")
    try:
        # the ranks start at once; the parent writes what they read
        # (renamed into place whole) and runs the references of (d) and
        # (f) beside them
        script = f"ROOT = {ROOT!r}\nWORK = {work!r}\n" + SHARDED_SCRIPT
        box = {}

        def launch():
            try:
                box["ranks"] = run_ranks(script, SHARDED_RANKS,
                                         device="cuda",
                                         timeout=SHARDED_TIMEOUT)
            except BaseException as e:  # raised again below
                box["error"] = e

        thread = threading.Thread(target=launch, daemon=True)
        thread.start()
        try:
            clean = collect_hessians(cfg, params, calib, device="cuda")
            path = os.path.join(work, "hessians.npz")
            with open(path + ".tmp", "wb") as f:
                np.savez(f, **{k: h.cpu().numpy() for k, h in clean.items()})
            os.replace(path + ".tmp", path)
            path = os.path.join(work, "phase4_db.json")
            with open(path + ".tmp", "w") as f:
                json.dump(db_digests(db), f)
            os.replace(path + ".tmp", path)
            leaves = leaf_digests(params, calib)
            torch.cuda.synchronize()
            seconds["parent"] = time.perf_counter() - t0
            t1 = time.perf_counter()
            res = oneshot_prune(cfg, params, calib, sharded_env(),
                                MAIN_TARGETS, hessians=clean, device="cuda",
                                **SHARDED_SEARCH)
            single = family_of(res)
            single_search_s = res.stage_seconds["search"]
            del res
            torch.cuda.synchronize()
            seconds["parent_d"] = time.perf_counter() - t1
            t1 = time.perf_counter()
            one = single_process_trainer(torch, cfg, params, work)
            seconds["parent_f"] = time.perf_counter() - t1
        finally:
            thread.join()
        if "error" in box:
            raise box["error"]
        ranks = box["ranks"]
        seconds["ranks"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    n_evals = next(iter(single.values()))[4]
    print(f"sharded: {SHARDED_RANKS} ranks on the card; seconds "
          + json.dumps({k: round(v, 4) for k, v in seconds.items()})
          + f"; the parent's search {single_search_s:.4f} s, {n_evals} "
          "candidates scored")
    for r in ranks:
        rank = r["rank"]
        print(f"  rank {rank}: seconds " + json.dumps(
            {k: round(v, 4) for k, v in r["seconds"].items()})
            + f"; (a) Hessians rel err {r['a_rel']:.3e}; (b) orders equal "
            f"{r['b_orders']}, errors max rel diff {r['b_errors_rel']:.3e}, "
            f"bit for bit {r['b_exact']}; (c) {r['c_counts']}, breaker "
            f"open {r['c_breaker']}, site hits {r['c_hits']}, equal to (b) "
            f"{r['c_exact']}; (d) {r['d'] == single}, search "
            f"{r['d_search_s']:.4f} s, placed scoring {r['d_scoring']}; (e) "
            f"{r['e'] == single}, search {r['e_search_s']:.4f} s, "
            f"{r['e_counts']}, placed scoring {r['e_scoring']}")
        check(r["leaves"] == leaves, f"sharded rank {rank}: weights or "
              "tokens differ from phase 4's: " + str(sorted(
                  k for k in leaves if r["leaves"].get(k) != leaves[k])))
        check(r["a_keys"] and r["a_rel"] < 1e-5,
              f"sharded (a) rank {rank}: Hessians {r['a_rel']:.3e} from the "
              "single-process ones")
        check(r["b_exact"], f"sharded (b) rank {rank}: the database differs "
              "from phase 4's")
        check(r["c_exact"] and r["c_breaker"] and r["c_hits"] == 1
              and r["c_counts"] == {"injected": {"db.sharded_group": 1},
                                    "demotions": {"db.sharded_group": 1}},
              f"sharded (c) rank {rank}: the demotion went wrong")
        check(r["d"] == single and not r["d_counts"],
              f"sharded (d) rank {rank}: the placed search differs from "
              f"the single-process one ({r['d_counts']})")
        own = [int(k) for k in r["d_scoring"]["scored"]]
        check(all(k % SHARDED_RANKS == rank for k in own),
              f"sharded (d) rank {rank} scored the targets {own}")
        check(r["e"] == single and r["e_scoring"]["all_gathers"] == 0
              and r["e_counts"] == {
                  **({"injected": {"spdy.batched_eval": 1}} if rank == 0
                     else {}),
                  "demotions": {"spdy.batched_eval": 1}},
              f"sharded (e) rank {rank}: the demotion went wrong "
              f"({r['e_counts']}, {r['e_scoring']})")
    check_mesh_parts(ranks, one)
    scored = sum(n for r in ranks for n in r["d_scoring"]["scored"].values())
    gathers = {r["d_scoring"]["all_gathers"] for r in ranks}
    check(scored == n_evals and len(gathers) == 1 and min(gathers) >= 1,
          f"sharded (d): the ranks scored {scored} of {n_evals} candidates "
          f"with all-gathers {gathers}")
    for t, (assignment, speedup, score, _, _) in single.items():
        print(f"  (d) {t}x: speedup {speedup:.4f}x, score {score!r}, "
              f"structures removed {sum(assignment.values())}")
    launches = [{k: r["launches"][k] for k in SHARDED_KERNELS} for r in ranks]
    print("sharded_launches: " + json.dumps(launches))
    for rank, got in enumerate(launches):
        for name, n in got.items():
            check(n > 0, f"sharded rank {rank}: {name} never launched")
    return [r["launches"] for r in ranks]


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def main() -> int:
    # the train step's deterministic algorithms need a fixed cuBLAS
    # workspace, set before the first cuBLAS call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    try:
        import torch
    except ImportError as e:
        return fail(f"PyTorch is not installed ({e})")
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is False: this smoke run "
                    "needs an NVIDIA GPU")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        return fail(f"no port package under {SRC}: run from a checkout "
                    "of the repository")
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False")

    from repro_torch import kernels
    from repro_torch.kernels import build

    watch_reports()

    t0 = time.perf_counter()
    reports = build.build_all()
    print(f"phase 1: built {sorted(reports) or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.2f} s")
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    t0 = time.perf_counter()
    records = check_kernels(torch, kernels)
    torch.cuda.synchronize()
    print(f"phase 2: kernels agree with their plain versions "
          f"({time.perf_counter() - t0:.2f} s)")

    t0 = time.perf_counter()
    check_small_slice(torch)
    check_to_host(torch)
    check_small_serving(torch)
    check_small_ssm(torch, kernels)
    check_small_hybrid(torch, kernels)
    for name, changes, seed, what in SMALL_CROSS:
        check_small_cross(torch, name, changes, seed, what)
    check_small_moe(torch)
    print(f"phase 3: small slices agree between card and CPU "
          f"({time.perf_counter() - t0:.2f} s)")

    t0 = time.perf_counter()
    launches, cfg, params, calib, db, table, fam = run_main_path(torch,
                                                                 kernels)
    print(f"phase 4: main path done ({time.perf_counter() - t0:.2f} s)")

    t0 = time.perf_counter()
    sharded_launches = run_sharded_path(torch, cfg, params, calib, db)
    print(f"phase 18: sharded calibration and database done "
          f"({time.perf_counter() - t0:.2f} s)")

    t0 = time.perf_counter()
    run_search_paths(torch, cfg, params, calib, db, table)
    run_cache_path(torch, cfg, db, table)
    phase16_bc = time.perf_counter() - t0
    print(f"phase 16 (b, c): serial search and latency cache done "
          f"({phase16_bc:.2f} s)")

    t0 = time.perf_counter()
    launches.update({name: n for name, n in serve_family(
        torch, kernels, params, calib, db, fam).items()
        if name in SERVING_KERNELS})
    serve_cli(torch, kernels)
    print(f"phase 5: serving done ({time.perf_counter() - t0:.2f} s)")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    chaos_launches = run_chaos_path(torch, kernels, cfg, params, calib, db,
                                    table, fam)
    print(f"phase 17: robustness done ({time.perf_counter() - t0:.2f} s)")
    del cfg, table
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    train_launches = run_train_path(torch, kernels, params, calib, db, fam)
    print(f"phase 8: finetune, resume and rebuild done "
          f"({time.perf_counter() - t0:.2f} s)")
    del db, fam
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    family_launches = run_family_path(torch, kernels, params, calib)
    print(f"phase 9: family engine run, killed and resumed "
          f"({time.perf_counter() - t0:.2f} s)")
    del params, calib
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ssm_launches = run_ssm_path(torch, kernels)
    launches["ssd_intra_chunk"] = ssm_launches["ssd_intra_chunk"]
    print(f"phase 6: Mamba-2 path done ({time.perf_counter() - t0:.2f} s)")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ssm_family_launches = run_ssm_family_path(torch, kernels)
    launches["ssd_intra_chunk_backward"] = ssm_family_launches[
        "ssd_intra_chunk_backward"]
    print(f"phase 10: Mamba-2 family engine run, killed and resumed "
          f"({time.perf_counter() - t0:.2f} s)")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    moe_launches, moe_params, moe_calib = run_moe_path(torch, kernels)
    print(f"phase 7: MoE path done ({time.perf_counter() - t0:.2f} s)")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    moe_family_launches = run_moe_family_path(torch, kernels, moe_params,
                                              moe_calib)
    del moe_params, moe_calib
    print(f"phase 11: MoE family engine run and repeated train steps "
          f"({time.perf_counter() - t0:.2f} s)")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    run_examples(torch, kernels)
    print(f"phase 12: examples done ({time.perf_counter() - t0:.2f} s)")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    hybrid_launches = run_hybrid_path(torch, kernels)
    print(f"phase 13: Hymba path done ({time.perf_counter() - t0:.2f} s)")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    encdec_launches = run_encdec_path(torch, kernels)
    print(f"phase 14: Whisper path done ({time.perf_counter() - t0:.2f} s)")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    vlm_launches, vlm_cfg, vlm_params, vlm_calib = run_vlm_path(torch,
                                                                kernels)
    print(f"phase 15: VLM path done ({time.perf_counter() - t0:.2f} s)")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    compact_launches, compact_s, compact_rows = run_compact_path(
        torch, kernels, vlm_cfg, vlm_params, vlm_calib)
    records["obs_downdate"]["other_shapes"].extend(compact_rows)
    del vlm_params, vlm_calib
    print(f"phase 16 (a): compacted databases done "
          f"({time.perf_counter() - t0:.2f} s; with (b, c) "
          f"{time.perf_counter() - t0 + phase16_bc:.2f} s); seconds "
          + json.dumps({k: round(v, 3) if isinstance(v, float) else v
                        for k, v in compact_s.items()}))

    for name, rec in records.items():
        rec["launches"] = launches[name]
        rec["moe_launches"] = moe_launches[name]
        rec["train_launches"] = train_launches[name]
        rec["family_launches"] = family_launches[name]
        rec["ssm_family_launches"] = ssm_family_launches[name]
        rec["moe_family_launches"] = moe_family_launches[name]
        rec["hybrid_launches"] = hybrid_launches[name]
        rec["encdec_launches"] = encdec_launches[name]
        rec["vlm_launches"] = vlm_launches[name]
        rec["compact_launches"] = compact_launches[name]
        rec["chaos_launches"] = chaos_launches[name]
        rec["sharded_launches"] = [r[name] for r in sharded_launches]
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"]
    # flash attention's and the SSD passes' device-only times ride beside
    # their eager ones (the SSD backward's also split by pass),
    # hessian_accum's and the SSD pass's other shapes
    # beside their main shape, and each kernel's launches on the MoE path
    # (phase 7), on the trainer's path (phase 8) and in the family engines'
    # runs A (phases 9 and 10), the MoE family run (phase 11), the Hymba
    # path (phase 13), the Whisper path (phase 14), the VLM path (phase
    # 15) and the compacted databases (phase 16) beside those on its own
    # path (phases 4-6; the SSD backward's own path is phase 10), the
    # robustness phase's (17) and each rank's of the sharded phase (18)
    extra = ["note", "device_ms", "library_device_ms", "passes_ms",
             "other_shapes", "moe_launches", "train_launches",
             "family_launches", "ssm_family_launches", "moe_family_launches",
             "hybrid_launches", "encdec_launches", "vlm_launches",
             "compact_launches", "chaos_launches", "sharded_launches"]
    check_reports()
    print(json.dumps({"kernels": [{k: r[k] for k in keys + extra if k in r}
                                  for r in records.values()]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as e:  # any failed phase: non-zero, no result line
        import traceback
        traceback.print_exc()
        sys.exit(fail(f"{type(e).__name__}: {e}"))
