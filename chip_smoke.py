"""On-card check of the PyTorch port's serving, evaluation and training
paths, training without XL memory, the two fused probes and the reference's
fast numerics (int8 BD forward, int8 dphi backward, 8-bit dropout draws)
among them, the train CLI's ``--profile`` trace, the host-parity sampler,
the unfused attention path, and of the chain raw MIDI -> preprocess ->
train -> generate: ``python3 chip_smoke.py``.

Needs one CUDA device (an H100: the kernels are built for sm_90a) and exits
non-zero without one.  From the repository root it:

1. builds ``commu_tpu_torch/csrc/*.cu`` with nvcc (first use; one nvcc per
   source, all started together), prints the registers, static shared
   memory and spill bytes that ptxas reported for the kernels of
   ``embed_grad.cu``, ``project_mem_kv.cu``, the two attention
   backwards' sources, ``ffn_block_bwd.cu``, ``ring_write_layer.cu``, both
   attention forwards' sources, ``ffn_block_fwd.cu``, ``nll_fwd.cu``,
   ``nll_bwd.cu`` and ``dropout_bdt.cu``, and holds every kernel
   against its plain PyTorch twin on the card, at the serving path's shapes
   and at the eval
   shape (B = 10, T = 128, M = 2048 at ``ModelConfig()`` width), in float32
   and bfloat16, with the stated tolerance; times both with CUDA events;
   then the training path's backward kernels and the forward kernels' save
   outputs at the training shape (B = 256, T = 128, M = 1024), without
   dropout and at p = 0.1 from a fixed seed, with the dropout kernel: each
   mask's realised keep rate on the card, a rerun's bits, a second seed;
   then, the same way, the kernels of training without memory (the
   no-memory forward's save outputs and its backward at B = 256, T = 128),
   the projecting forward (also against the two kernels it joins, at the
   same tolerance), the fused-o form of the FFN kernels, and the stacked
   ring write;
   then the fast numerics' forms at the training shape, over the memory and
   without it, and the int8 forward at the eval shape: the int8 BD forward
   and the int8 dphi backward of both attentions (with 8-bit masks) and the
   8-bit form of every kernel that draws, each against its twin, with each
   mask's keep rate held to 1 - 26/256; then the same checks without
   memory at one chunk of a step at ``train.tgt_length=512`` (B = 64,
   T = 512: the int8 forward and backward, the FFN kernels and the dropout
   kernel at 8 bits); then the small kernels #13-#15
   against their library calls, and #1 at the serving prefill, by device
   time (CUDA graphs, in turns);
2. checks the full-width model's prefill and decode logits on the card
   against the same model on the CPU (plain versions);
3. writes seeded random weights at ``ModelConfig()`` full width to a
   reference-format ``.pt``; holds the decode episode's captured CUDA
   graphs against its eager loop (``graphs=False``) at G = 8, generation
   length 600 (views 256, 512, 640), in float32 and bfloat16, at
   temperature 0 and 0.95: the same tokens, failed flags and chord_rem,
   with ms per decode step both ways, the capture's seconds, the card's
   busy share over 32 replays and #15's device time inside the step graph
   (``[episode]`` lines); then runs the serving loop of
   ``python -m commu_tpu_torch.generate --serve --lenient`` in-process
   (``--warm`` first), with requests of width 1 and 8, at generation length
   1024 and at the default (cache capacity 4096), in float32 and bfloat16;
   every answer must be ok, every .mid it lists must parse back, every
   serving kernel must have launched and ``cache_append`` once per decode
   step; then the eager yardstick for the width-8 float32 request at 1024,
   whose sequences the graphed pipeline must repeat (``[serve]`` lines);
4. runs a short full-width eval (batch 2, tgt 128, mem 256, a ring that
   wraps) with ``Trainer.evaluate`` on the card and on the CPU (plain
   versions) and holds the NLL sums and token counts against each other;
5. runs ``Trainer.evaluate("valid")`` at ``ModelConfig()`` and
   ``EvaluateConfig()`` (batch 10, tgt 128, mem 2048) over a seeded
   synthetic val split, in float32 and bfloat16: the NLL must be finite and
   every eval kernel must have launched;
6. runs four train steps at full width (batch 4, tgt 128, mem 256, f32) on
   the card and on the CPU (plain versions) from the same weights, at
   dropout 0 and at dropout 0.1 from the same seeds, and holds the metrics
   and the updated parameters against each other; then the same at dropout
   0.1 in the fast mode (the three levers set), over memory and without;
7. runs ``python -m commu_tpu_torch.train`` in-process at the reference
   shape (``TrainConfig()``: batch 256, tgt 128, mem 1024) over a seeded
   synthetic corpus of 600 sequences, with an eval, both checkpoints and a
   test pass at the last step and ``final_test``: at dropout 0 (4 steps,
   bfloat16), then at ``ModelConfig()`` unchanged (dropout 0.1; 12 steps,
   bfloat16 then float32): the loss must be finite and every training
   kernel must have launched; prints ms/step, train tokens/s and peak
   device memory.  These runs, the ones without memory and the probes pass
   ``--precise_bd`` (the exact mode: what they measured before the CLI had
   another); then the CLI runs WITHOUT the flag, in its default fast mode,
   12 steps in bfloat16 and float32, over the memory and at
   ``train.mem_length=0``: the int8 and 8-bit forms must launch, the exact
   forms of the attention kernels not at all, and ``os.environ`` must come
   back as it was; then 4 fast-mode steps in bfloat16 without memory at
   ``train.tgt_length=512``, a window past the first design's shared
   memory;
8. trains without XL memory: four full-width steps card against CPU at
   memory capacity 0, then the same CLI with ``--set train.mem_length=0
   --set evaluate.mem_length=0`` at ``TrainConfig()`` and ``ModelConfig()``
   unchanged, in bfloat16 then float32: the no-memory forward and backward
   must launch 6 times a step and no memory kernel at all;
9. runs the fused probes: the CLI at the reference shape with
   ``COMMU_PROJ_IN_FWD=1`` and with ``COMMU_O_IN_FFN=1`` too (every step's
   ``nll_sum`` within rtol ``MODEL_TOL`` of the default run's), each with a
   test pass through ``Trainer.evaluate``: the
   projecting forward and the fused-o kernels must launch, the standalone
   projection not at all; and writes every slab of a ring of the training
   shape with ``ring_write`` against the slab ``copy_``;
9b. ``[levers]``: the reference's five opt-in levers of its attention
   kernels (``COMMU_SOFTMAX=clamp``, ``COMMU_DEFER_NORM=1``,
   ``COMMU_SCALE_HOIST=1``, ``COMMU_INT8_DQ=1``, ``COMMU_INT8_DK=1``): the
   lever library (``-DCOMMU_LEVERS``; built in a thread beside the main
   library, before the first phase), each lever form of #1-#4 and #6
   against its twin at ``ModelConfig()`` and at units 1536 / 12 heads, at the training shape,
   without memory, at the eval shape and at the serving prefill, in both
   numerics modes, with its ms beside the default form's in turns
   (``check_lever_kernels``); then ``LEVER_STEPS`` fast bf16 CLI steps at
   ``TrainConfig()`` under each lever (finite losses, its form launched in
   place of the fast mode's), step 0's gradients under int8 dq and dk
   against the default's within the reference's bounds, and two short runs
   under all five levers, without memory and with ``COMMU_PROJ_IN_FWD=1``
   (``levers_phase``);
10. ``[profile]``: ``python -m commu_tpu_torch.train --profile`` in the
   fast mode, f32, at ``TrainConfig()``, 16 steps over M = 1024 and again
   without memory; each trace of steps 4-10 must hold every kernel of the
   step at its launches a step (``commu::<kernel>`` ranges, one per launch)
   with device time; prints the device ms a step of each kernel, the
   cuBLAS/CUTLASS products, Adam, the clip, the ten largest other kernels
   and copies, the idle gaps, and the step time with the profiler on and
   off; ``[host]``: ``MidiGenerationPipeline(sampler="host")`` against the
   device sampler at temperature 0 on the seeded weights (width 1,
   length 1024: the same tokens; #1 and #7 six times, #15 at every
   committed step), then ``generate --sampler host`` at 0.95 (the .mid
   parses back), then ``[gumbel]``: ``forward_generate_gumbel`` over a
   ring, card against CPU from one uniform draw (equal one-hot samples);
   ``[unfused]``: the train CLI with ``--set
   model.attn_impl=xla`` at dropout 0, 11 f32 steps (profiled) and 4 bf16,
   step 0 against the kernel path's ``--precise_bd`` step 0 (rtol
   ``MODEL_TOL``), no launch and no device event of a ``csrc`` kernel in
   the trace, ``Trainer.evaluate`` at ``EvaluateConfig()`` on both paths
   (rtol ``MODEL_TOL``), then 4 steps at ``model.clamp_len=64`` and dropout
   0.1 (finite losses); ``[wide]``: the attention kernels' wide forms at
   ``WIDE_WIDTHS`` (units 768 / 12 heads, 1024 / 8, 1024 / 4 and 1536 /
   12; #1 and #2 on their wide tensor-core body, which alone with the
   narrow one their sources hold; #3 and #4 on the wide backward passes,
   their sources holding no kernel that their headers do not name)
   against their twins with their ``[bound]`` lines (with ``--parent
   DIR``, first #1, #2 and #6, then #3 and #4, of the commit at DIR in
   turns with this tree's), then the train CLI at the four widths, exact against the
   unfused path, then fast (``wide_phase``); ``[ddp]``: the train CLI
   under a process group, NCCL at world 1 bit-equal to one process, then
   two gloo ranks on the card against one process (``ddp_phase``);
11. runs the reference's three CLIs as one chain (``corpus chain``):
   writes a raw corpus of 16 train and 4 val clips (8 bars each, seeded,
   with the port's own ``midi``) and its metadata CSV, one parent in D
   major (dropped) and one whose transposes leave the MIDI range (skipped);
   runs ``python -m commu_tpu_torch.preprocess --num_cores 4`` in a
   subprocess, which must give each kept parent's 60 variants less the
   skipped ones (its seconds, sequences and tokens per split printed) and
   must have parsed with the native MIDI parser built from
   ``midi/native/smf_native.cpp`` (``[native]``: its path, and the seconds
   to parse the clips and their variants with it and in Python); runs
   the train CLI in-process on its ``output_npy`` at ``TrainConfig()`` and
   ``ModelConfig()``, fast mode, 4 steps in bfloat16 with an eval and both
   checkpoints (ms/step, train tokens/s, the epochs covered); then
   ``python -m commu_tpu_torch.generate --num_generate 8 --lenient``
   in-process from that run's ``checkpoint_best.pt`` on a val record's
   metadata: the captured episode and #1, #7 and #15 must launch, and every
   ``.mid`` must parse back;
12. ``[converge]``, the short form of ``--converge``: builds the 400-clip
   synthetic corpus (``python -m commu_tpu_torch.data.synthetic``) and runs
   100 fast bf16 steps of the train CLI on it in a subprocess at
   ``TrainConfig()``: train nll at step 100 finite and under 6.0;
13. prints one JSON line of per-kernel results (time, plain twin's time,
   the card's bound for the same bytes and operations, a library call's
   time where one computes the same function) with the launches of each
   path, the card's name and power limit, and
   ``{"ok": true, "device": {...}}`` as the last line.

Any failure raises, so the exit code is non-zero and no result line prints.

``python3 chip_smoke.py --passes`` is a measurement and no check of the
port: it builds the kernels, splits one launch of each NLL kernel at the
training shape into its CUDA kernels, times the forms of both attention
forwards and the FFN forward apart (``[forms]`` lines: float and int8 BD,
with and without the residual and the 8-bit masks, the training, eval and
serving shapes, the no-memory forward at T = 11-64 too), runs the fast
numerics' kernel phase alone, the small kernels by device time, and
splits one
launch of each attention backward (float form and int8 form) and of the FFN
backward's and forward's 8-bit forms at the training shape, in float32 and
bfloat16, into its CUDA kernels with ``torch.profiler`` (``[passes]``
lines), then one launch of #4 (train shape) and one of #3 (the window
alone) at each of ``WIDE_WIDTHS``, f32 and bf16, float and int8 forms,
p = 0.1, each kernel with the least time of its group (``[passes]
wide``); ``--passes --wide`` runs that split alone.  Then it exits
without the result lines.  Copied into a checkout of another commit and
run there, it times that commit's kernels the same way.

``python3 chip_smoke.py --levers`` runs phase 9b alone (the lever
library's build, the ``[levers]`` checks and times, the lever runs of the
train CLI).

``python3 chip_smoke.py --steps`` is a measurement too: the eval window
(phase 5, twice: the second pass is warm) and the train CLI's ms/step at
the reference shape, 16 steps in
the fast mode over the memory and without it and 8 with ``--precise_bd``
over the memory and without it, in bfloat16 and float32 (``[eval]`` and ``[train]`` lines), with the same
launch checks.  Run in turns with a copy of it in another commit's
checkout (parent, change, change, parent), it compares the two trees'
steps on one card.

``python3 chip_smoke.py --serve`` runs phase 3's episode graphs and serve
loop alone (ms per decode step, request wall times); copied into a checkout
of a tree without captured episodes, it runs that tree's serve loop alone.

``python3 chip_smoke.py --chain`` runs phase 10 alone, after the same
fast-mode bfloat16 train run over phase 7's seeded corpus, as many steps,
for a step time to hold the preprocessed corpus's against.

``python3 chip_smoke.py --profile``, ``--host``, ``--unfused``, ``--wide``
and ``--ddp`` run those parts of phase 10 alone (any of them together),
after writing the seeded corpus or the weights they read.  ``--grads`` is
a measurement (``grad_attribution``): the kernel path's and the unfused
path's gradients, f32 and bf16, against the unfused path's in f64, by
parameter group.

``python3 chip_smoke.py --parse N`` runs the preprocess over N seeded raw
clips on the host alone (``parse_profile``: parse, augment, encode and
concat timed apart, each parser's seconds; ``[parse]`` lines), after the
build and the card's lines.

``python3 chip_smoke.py --sums`` holds ``csrc/sums.cu``'s deep sums (the
tile, the two batch sums) against f64 at the main path's depths, and one
``mma`` step and one staged chunk alone, and times them (``[sums]`` lines,
``sums_check``).

``python3 chip_smoke.py --converge`` builds the JAX package's synthetic
corpus (400 clips, seed 1111) with the port and runs 2,000 fast bf16 steps
of the train CLI on it at ``TrainConfig()``: train and val nll at the JAX
log's milestones, beside that log's (``[converge]``, ``converge_phase``);
val nll at step 2000 must be within 2% of the JAX run's.

``python3 chip_smoke.py --c2`` is a measurement: layer 0's unfused bf16
operations at steps 0 and 3 of ``[wide]``'s unfused bf16 run, each against
f64 from the same inputs (``[c2]``, ``c2_reading``).

``python3 chip_smoke.py --kernels`` runs phase 1's checks at the training
shape alone (the train kernels, the capacity-0 and probe kernels, the
fast-numerics kernels: ``[kernel]`` lines with each kernel's and its
twin's ms); copied into a checkout of another commit, it times that
commit's kernels, so two trees' default forms compare in one call.

``python3 chip_smoke.py --kv`` times #5 (``project_mem_kv``) at
``ModelConfig()``'s training and eval shapes and at ``WIDE_WIDTHS``'
training shape against its twin and one ``torch.matmul``, then, at the
five widths, #4's dWk + dWv sums alone (``report_dw_sums``: the warpgroup
product through ``csrc/sums.cu`` against f64, beside one ``torch.matmul``)
and one launch of #4 in its float and int8 forms, f32 and bf16, with the
sums' bound (``[kv]`` lines, ``time_kv``); ``--passes`` runs it first,
with each launch of #4 split into its CUDA kernels.  Copied into a
checkout of another commit, it times that commit's kernels (the sums
alone where that commit has the warpgroup product): parent, tree, tree,
parent in one call compare them.

``python3 chip_smoke.py --eval_window`` times phase 5's eval alone: six
warm passes a dtype by the host's clock and one traced pass (the card's
busy time and idle share a window, the memory forward's device time), with
a hash of the memory forward's SASS; run in turns in two checkouts in the
same way.
"""
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

F32_TOL = 1e-4   # f32: kernel and plain sum in different orders
BF16_TOL = 2e-2  # bf16: a one-ulp rounding flip is ~4e-3 relative
MODEL_TOL = 1e-3  # six f32 layers, card vs CPU
# steps of the CLI runs in the exact mode (ms/step from step 3 on, as the
# fast-mode runs' 12 steps give it): fewer than the fast runs', to keep the
# whole script's time
PRECISE_STEPS = 8
# NVIDIA H100 SXM (data sheet): device memory rate, and the float32 rate
# outside the tensor cores (what the f32 FMA loops of the other kernels
# enter the bound at)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# the same data sheet's dense int8 tensor-core rate: what the int8 products
# enter the bound at (ds_q psi_q^T of the backwards and phi_q psi_q of both
# attention forwards run on the int8 tensor cores at every width)
INT8_OPS_PER_S = 1979e12
# its dense TF32 and bf16 tensor-core rates: what the products of
# project_mem_kv, of the attention and FFN backwards and of the memory
# attention and FFN forwards enter the bound at (3xTF32 in f32: three passes
# counted; bf16 in bf16)
TF32_FLOPS_PER_S = 495e12
BF16_FLOPS_PER_S = 989e12
DROPOUT_P, DROPOUT_SEED = 0.1, 20240229
PASSES = "--passes" in sys.argv[1:]  # the measurement alone, see above
STEPS = "--steps" in sys.argv[1:]    # the step times alone, see above
EVAL_WINDOW = "--eval_window" in sys.argv[1:]  # the eval window, see above
SERVE_ONLY = "--serve" in sys.argv[1:]  # the serving measurement, see above
CHAIN_ONLY = "--chain" in sys.argv[1:]  # the corpus chain, see above
# the trace split, the host sampler, the unfused path: each alone, see above
PROFILE_ONLY = "--profile" in sys.argv[1:]
HOST_ONLY = "--host" in sys.argv[1:]
UNFUSED_ONLY = "--unfused" in sys.argv[1:]
# the wide forms and the data-parallel runs: each alone, see above
WIDE_ONLY = "--wide" in sys.argv[1:]
# --wide --proj: #6 alone at the wide widths (its [wide] lines, and with
# --parent its in-turns lines), see check_wide_kernels
PROJ_ONLY = "--proj" in sys.argv[1:]
DDP_ONLY = "--ddp" in sys.argv[1:]
# the kernel path's and the unfused path's gradients against f64, see
# grad_attribution
GRADS_ONLY = "--grads" in sys.argv[1:]
SASS_ONLY = "--sass" in sys.argv[1:]  # the build's [ptxas] and [sass] lines
# the kernel checks at the training shape alone (phase 1's train,
# capacity-0 and probe, and fast-numerics kernels), see above
KERNELS_ONLY = "--kernels" in sys.argv[1:]
# the shared deep sums against f64, see sums_check
SUMS_ONLY = "--sums" in sys.argv[1:]
# #5 and #4's launch at ModelConfig() and the wide widths, see time_kv
KV_ONLY = "--kv" in sys.argv[1:]
# layer 0's unfused bf16 operations against f64, see c2_reading
C2_ONLY = "--c2" in sys.argv[1:]
LEVERS_ONLY = "--levers" in sys.argv[1:]
# the 2,000-step convergence run alone, see converge_phase
CONVERGE_ONLY = "--converge" in sys.argv[1:]
# --parse N: the preprocess at N clips on the host alone, see above
PARSE_CLIPS = (int(sys.argv[sys.argv.index("--parse") + 1])
               if "--parse" in sys.argv[1:] else None)
# Transformer-XL's published widths at ComMU's depth: (units, heads,
# inner_size): dh 64 with 2F 768, and enwik8-large's dh 128 with 2F 1024;
# then dh 256 (units 1024, 4 heads) and a query side past 227 KB of shared
# memory (units 1536, 12 heads: dh 128, 2F 1536), where #6 runs its
# streamed form
WIDE_WIDTHS = ((768, 12, 3072), (1024, 8, 3072), (1024, 4, 4096),
               (1536, 12, 6144))
WIDE_STEPS = 4
# --parent DIR: a checkout of another commit (``git archive``) whose three
# attention forwards and two attention backwards [wide] times in turns with
# this tree's (wide_in_turns, wide_bwd_in_turns)
PARENT_DIR = (Path(sys.argv[sys.argv.index("--parent") + 1])
              if "--parent" in sys.argv[1:] else None)
# [wide]: the exact kernel path's nll_sum and grad_norm at every step.  f32:
# against the unfused path's within 1e-5, now that the tensor cores' deep
# f32 sums add each step's product in round-to-nearest f32 (reduce.cuh;
# the kernel path's gradient fell short of f64's by 1.6-3.9e-5 while the
# sums stayed in the mma accumulator, and was held at 1e-4).  bf16: against
# the unfused f32 run's (the f32 trajectory, which both f32 paths share
# within 1e-5) within 1.5e-3.  Against the unfused bf16 run, its first
# yardstick, it read up to 9.7e-4 at units 768-1024, and 3.1e-3 at 1536,
# where the unfused bf16 run was the one 3.2e-3 off the f32 trajectory and
# the kernel path 7e-5 (both printed)
WIDE_TOL = {"float32": 1e-5, "bfloat16": 1.5e-3}
# [ddp]: the gloo run's last weights against the oracle's: the elements
# whose Adam sqrt(v) is at least DDP_HELD_TAU x their tensor's rms within
# DDP_HELD_TOL x the learning rates the steps applied (the reading: 0.0898,
# Adam's amplification of sums that cancel, see _held_weights), and each
# tensor's difference within DDP_MOVED_TOL of its update's norm (2.29e-4)
DDP_HELD_TAU, DDP_HELD_TOL, DDP_MOVED_TOL = 0.1, 0.2, 5e-4
EVAL_PASSES = 6  # warm passes of each dtype under --eval_window
KEEP_RATE = 1.0 - 6554 / 65536  # t16 = round(0.1 * 65536)
KEEP_RATE_8 = 1.0 - 26 / 256    # t8 = round(0.1 * 256)
# the val split of the eval phases: 20 sequences, 33,520 tokens
EVAL_LENGTHS = ([3000] + [200 + 140 * i for i in range(9)] + [3000]
                + [2900 - 150 * i for i in range(9)])
NO_MEMORY = ("--set", "train.mem_length=0", "--set", "evaluate.mem_length=0")
LONG_WINDOW = ("--set", "train.tgt_length=512")
# (B, T) of one chunk of that run's step: batch 256 over batch_chunk 4
LONG_CHUNK = (64, 512)
FAST_ENV = {"COMMU_BD_INT8": "1", "COMMU_BD_INT8_BWD": "1",
            "COMMU_DROPOUT_BITS": "8"}
KERNEL_INFO = {
    "rel_attention_fwd": ("commu_tpu_torch/csrc/rel_attention_fwd.cu",
                          "commu_tpu/ops/fused_attention.py:698"),
    "ffn_block_fwd": ("commu_tpu_torch/csrc/ffn_block_fwd.cu",
                      "commu_tpu/ops/fused_ffn.py:120"),
    "cache_append": ("commu_tpu_torch/csrc/cache_append.cu",
                     "commu_tpu/ops/layout.py:126"),
    "project_mem_kv": ("commu_tpu_torch/csrc/project_mem_kv.cu",
                       "commu_tpu/ops/fused_attention.py:1539"),
    "rel_attention_mem_fwd": ("commu_tpu_torch/csrc/rel_attention_mem_fwd.cu",
                              "commu_tpu/ops/fused_attention.py:698"),
    "ring_write_layer": ("commu_tpu_torch/csrc/ring_write_layer.cu",
                         "commu_tpu/ops/layout.py:70"),
    "nll_fwd": ("commu_tpu_torch/csrc/nll_fwd.cu",
                "commu_tpu/ops/fused_nll.py:58"),
    "rel_attention_mem_bwd": ("commu_tpu_torch/csrc/rel_attention_mem_bwd.cu",
                              "commu_tpu/ops/fused_attention.py:1363"),
    "ffn_block_bwd": ("commu_tpu_torch/csrc/ffn_block_bwd.cu",
                      "commu_tpu/ops/fused_ffn.py:198"),
    "nll_bwd": ("commu_tpu_torch/csrc/nll_bwd.cu",
                "commu_tpu/ops/fused_nll.py:78"),
    "embed_grad": ("commu_tpu_torch/csrc/embed_grad.cu",
                   "commu_tpu/ops/embed.py:27"),
    "dropout_bdt": ("commu_tpu_torch/csrc/dropout_bdt.cu",
                    "commu_tpu/ops/dropout.py:40"),
    "rel_attention_bwd": ("commu_tpu_torch/csrc/rel_attention_bwd.cu",
                          "commu_tpu/ops/fused_attention.py:854"),
    "rel_attention_proj_fwd": (
        "commu_tpu_torch/csrc/rel_attention_proj_fwd.cu",
        "commu_tpu/ops/fused_attention.py:728"),
    "ffn_block_fused_o_fwd": ("commu_tpu_torch/csrc/ffn_block_fwd.cu",
                              "commu_tpu/ops/fused_ffn.py:482"),
    "ffn_block_fused_o_bwd": ("commu_tpu_torch/csrc/ffn_block_bwd.cu",
                              "commu_tpu/ops/fused_ffn.py:482"),
    "ring_write": ("commu_tpu_torch/csrc/ring_write.cu",
                   "commu_tpu/ops/layout.py:203"),
}
# the fast numerics' forms that a main path launches: rows of their own,
# from the same sources; "replaces" names the reference's branch
for _name, _line in (("rel_attention_fwd[int8]", 486),
                     ("rel_attention_mem_fwd[int8]", 486),
                     ("rel_attention_bwd[int8]", 975),
                     ("rel_attention_mem_bwd[int8]", 975),
                     ("ffn_block_fwd[bits8]", 306), ("ffn_block_bwd[bits8]", 306),
                     ("dropout_bdt[bits8]", 306)):
    KERNEL_INFO[_name] = (KERNEL_INFO[_name.split("[")[0]][0],
                          f"commu_tpu/ops/fused_attention.py:{_line}")
# the lever forms the levers phase drives (ops.fused_attention.Levers), from
# the same sources built again with -DCOMMU_LEVERS; "replaces" names the
# reference's branch: the clamped softmax, the keep-scale after P v
# (COMMU_DEFER_NORM and COMMU_SCALE_HOIST), the int8 dq and dk
LEVER_ROWS = (("rel_attention_mem_fwd[clamp]", 597),
              ("rel_attention_mem_fwd[after]", 609),
              ("rel_attention_fwd[clamp+after]", 597),
              ("rel_attention_proj_fwd[clamp+after]", 597),
              ("rel_attention_mem_bwd[int8_dq]", 995),
              ("rel_attention_mem_bwd[int8_dk]", 961),
              ("rel_attention_mem_bwd[int8_dq+dk]", 961),
              ("rel_attention_bwd[int8_dq+dk]", 961))
for _name, _line in LEVER_ROWS:
    KERNEL_INFO[_name] = (KERNEL_INFO[_name.split("[")[0]][0],
                          f"commu_tpu/ops/fused_attention.py:{_line}")
SERVE_KERNELS = ("rel_attention_fwd", "ffn_block_fwd", "cache_append")
EVAL_KERNELS = ("project_mem_kv", "rel_attention_mem_fwd", "ring_write_layer",
                "nll_fwd", "ffn_block_fwd")
TRAIN_KERNELS = EVAL_KERNELS + ("rel_attention_mem_bwd", "ffn_block_bwd",
                                "nll_bwd", "embed_grad")
DROPOUT_TRAIN_KERNELS = TRAIN_KERNELS + ("dropout_bdt",)
MEMORY_KERNELS = ("project_mem_kv", "rel_attention_mem_fwd",
                  "rel_attention_mem_bwd", "rel_attention_proj_fwd",
                  "ring_write_layer")
CAPACITY0_KERNELS = ("rel_attention_fwd", "rel_attention_bwd", "ffn_block_fwd",
                     "ffn_block_bwd", "nll_fwd", "nll_bwd", "embed_grad",
                     "dropout_bdt")
# the fast mode's train runs: the int8 attention forms (train and eval
# windows both), the 8-bit FFN and dropout forms in the train steps, the
# FFN's plain form in the eval windows (no dropout there)
FAST_TRAIN_KERNELS = ("project_mem_kv", "rel_attention_mem_fwd[int8]",
                      "rel_attention_mem_bwd[int8]", "ffn_block_fwd[bits8]",
                      "ffn_block_bwd[bits8]", "ffn_block_fwd",
                      "dropout_bdt[bits8]", "ring_write_layer", "nll_fwd",
                      "nll_bwd", "embed_grad")
FAST_CAPACITY0_KERNELS = ("rel_attention_fwd[int8]", "rel_attention_bwd[int8]",
                          "ffn_block_fwd[bits8]", "ffn_block_bwd[bits8]",
                          "ffn_block_fwd", "dropout_bdt[bits8]", "nll_fwd",
                          "nll_bwd", "embed_grad")
# what a fast run must not launch: the exact attention forms and the 16-bit
# forms of the kernels that draw in a train step
FAST_UNWANTED = ("rel_attention_mem_fwd", "rel_attention_mem_bwd",
                 "rel_attention_fwd", "rel_attention_bwd", "ffn_block_bwd",
                 "dropout_bdt", "rel_attention_mem_fwd[bits8]",
                 "rel_attention_mem_bwd[bits8]", "rel_attention_fwd[bits8]",
                 "rel_attention_bwd[bits8]")


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def _cuda_ms(fn, iters=50, warmup=5) -> float:
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


def _graph_timer(fn, calls=100):
    """A CUDA graph of ``calls`` calls of ``fn`` and a function that replays
    it between two CUDA events and returns the device ms per call: no host
    dispatch between the calls, so a small kernel's time is the device's."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def replay() -> float:
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / calls
    return graph, replay


def _interleaved_graph_ms(fns, trials=9) -> dict:
    """{label: fn} -> {label: (median, min, max)} of the device ms per call,
    each fn timed by ``_graph_timer``, the graphs replayed in turns over
    ``trials`` rounds (one warm replay each first)."""
    import statistics

    timers = {label: _graph_timer(fn) for label, fn in fns.items()}
    for _, replay in timers.values():
        replay()
    times = {label: [] for label in fns}
    for _ in range(trials):
        for label, (_, replay) in timers.items():
            times[label].append(replay())
    return {label: (statistics.median(ts), min(ts), max(ts))
            for label, ts in times.items()}


def _print_passes(label, card, fn, iters=3) -> None:
    """Device ms of each CUDA kernel that one call of ``fn`` launches
    (``torch.profiler``, mean over ``iters`` calls), largest first."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = [(e.device_time_total / 1e3 / iters, e.count // iters, e.key)
            for e in prof.key_averages() if e.device_time_total > 0]
    if not rows:
        raise AssertionError(f"{label}: the profiler recorded no device time")
    print(f"[passes] {label}: {sum(r[0] for r in rows):.4f} ms in all "
          f"[{card}]")
    for ms, count, key in sorted(rows, reverse=True):
        print(f"[passes]   {ms:9.4f} ms  x{count}  {key[:100]}")


def _kernel_name(mangled: str) -> str:
    """The ``*_kernel`` identifier inside an Itanium-mangled name (a length
    in digits, then that many characters), or the name as it is.  The
    shortest such run wins: an anonymous namespace's tag can read as a
    longer one that ends where the kernel's name does."""
    import re

    found = []
    for run in re.finditer(r"\d+(?=[A-Za-z_])", mangled):
        for k in range(len(run.group())):
            name = mangled[run.end():run.end() + int(run.group()[k:])]
            if name.endswith("_kernel") and re.fullmatch(r"[A-Za-z_]\w*", name):
                found.append(name)
    return min(found, key=len) if found else mangled


def _kernel_label(mangled: str, source: str) -> str:
    """The ``*_kernel`` name in a mangled kernel name with its template
    forms spelled out (storage type, and the form tags of ``source``)."""
    import re

    forms = {"project_mem_kv.cu": {"Lb1E": " (X by TMA)",
                                   "Lb0E": " (X by plain loads)"}}
    forms["sums.cu"] = {**forms["project_mem_kv.cu"],
                        "I13__nv_bfloat16fL": " (f32 out)"}
    cp_async = {"Lb1E": " (X by cp.async)", "Lb0E": " (X by plain loads)"}
    forms["rel_attention_proj_fwd.cu"] = {**cp_async,
                                          "Li128E": " (wide: dh <= 128)",
                                          "Li256E": " (wide: dh <= 256)"}
    forms["ffn_block_bwd.cu"] = {"Dh1Out": " (dh1 = W2 df_c)",
                                 "DaOut": " (da = W1 dh1_c)",
                                 "DvecOut": " (fuse_o: dvec = Wo do_c)"}
    forms["rel_attention_mem_fwd.cu"] = {"Lb1E": " (int8 BD)",
                                         "Lb0E": " (float BD)",
                                         "Li128E": " (wide: dh <= 128)",
                                         "Li256E": " (wide: dh <= 256)"}
    forms["rel_attention_fwd.cu"] = forms["rel_attention_mem_fwd.cu"]
    forms["dropout_bdt.cu"] = {"Li1E": " (one word a thread)",
                               "Li4E": " (4 words a thread)",
                               "Li8E": " (8 words a thread)"}
    forms["ffn_block_fwd.cu"] = {"H1Out": " (h1 = W1^T a_c)",
                                 "Z2Out": " (f = W2^T h1_d)",
                                 "OOut": " (fuse_o: o = Wo^T vec)"}
    forms["nll_fwd.cu"] = {"FwdOut": " (logits, tile partials)"}
    forms["nll_bwd.cu"] = {"DlogitsOut": " (logits, dlogits)",
                           "DhOutIf": " (dh = emb^T dlogits, f32 dh)",
                           "DhOutI13": " (dh = emb^T dlogits, bf16 dh)",
                           "f13__nv_bfloat16E": " (demb, bf16 h)"}
    forms["ring_write_layer.cu"] = {"I5uint4L": " <16-byte words",
                                    "IjLi": " <4-byte words",
                                    "ItLi": " <2-byte words",
                                    "Li1024E": ", 1,024 threads>",
                                    "Li256E": ", 256 threads>"}
    name = _kernel_name(mangled)
    if name == "project_mem_kv_kernel":  # the mma.sync form before PR 24
        forms["project_mem_kv.cu"] = cp_async
    tail = mangled[mangled.find(name) + len(name):]
    kind = ("<float>" if tail.startswith("If") else "<bf16>"
            if tail.startswith("I13__nv_bfloat16") else "")
    if name == "bwd_queries_kernel":
        kind += " 2F=512" if "Li4E" in tail else " 2F=256"
    if name in ("bwd_keys_wide_kernel", "bwd_queries_split_kernel"):
        kind += "".join(f" (dh <= {n})" for n in (64, 128, 256)
                        if f"Li{n}E" in tail[:24])
    if name in ("bwd_keys_kernel", "bwd_keys_wide_kernel") and "Lb1E" in tail:
        kind += " (no dk)"  # <S, kNoDk>, <S, kDh, kNoDk>
    if name in ("bwd_queries_kernel", "bwd_queries_split_kernel"):
        # <S, kNH or kDh, kInt8, kRaw, kNoDq>
        flags = re.findall(r"Lb([01])E", tail)
        kind += " (int8 dphi)" if flags[:1] == ["1"] else " (float dphi)"
        kind += "".join(text for flag, text in zip(
            flags[1:], (" (raw ds, du)", " (no dq)")) if flag == "1")
    if name == "dw_sums_kernel":  # <S, kDeep>
        return name + kind + (" (64-deep chunks)" if "Lb1E" in tail else "")
    if name in ("ln1_bwd_kernel", "pad_matrix_kernel") and "Lb1E" in tail:
        kind += " (fuse_o: do_c)" if name == "ln1_bwd_kernel" else " (transposed)"
    if name == "ln1_kernel" and tail.startswith("I13__nv_bfloat16fE"):
        kind += " (fuse_o: f32 o)"
    return name + kind + "".join(
        text for tag, text in forms.get(source, {}).items() if tag in tail)


def print_ptxas(sources=("embed_grad.cu", "project_mem_kv.cu",
                         "rel_attention_bwd.cu", "rel_attention_mem_bwd.cu",
                         "ffn_block_bwd.cu", "ring_write_layer.cu",
                         "rel_attention_mem_fwd.cu", "ffn_block_fwd.cu",
                         "nll_fwd.cu", "nll_bwd.cu", "rel_attention_fwd.cu",
                         "dropout_bdt.cu", "rel_attention_proj_fwd.cu")) -> None:
    """The registers, static shared memory and spill bytes that ``nvcc
    -Xptxas -v`` reported for each kernel of ``sources`` in the last build
    (``commu_tpu_torch/_build/build.log``; dynamic shared memory is set at
    launch and not listed there)."""
    import re

    from commu_tpu_torch.ops import _build

    log = _build.BUILD_DIR / "build.log"
    if not log.exists():
        raise AssertionError(f"{log} is missing: the library was not built "
                             "in this checkout")
    source, name, found = None, None, {}
    for line in log.read_text().splitlines():
        if " -c -o " in line:
            source = Path(line.split()[-1]).name
        elif source in sources and "Compiling entry function" in line:
            name = re.search(r"'(\S+)'", line).group(1)
            found[name] = {"source": source}
        elif source in sources and name and "spill stores" in line:
            st, ld = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                               r"loads", line).groups()
            found[name].update(spill_stores=int(st), spill_loads=int(ld))
        elif source in sources and name and "Used" in line:
            used = re.search(r"Used (\d+) registers", line)
            smem = re.search(r"(\d+) bytes smem", line)
            found[name].update(registers=int(used.group(1)),
                               smem=int(smem.group(1)) if smem else 0)
    if {info["source"] for info in found.values()} != set(sources):
        raise AssertionError(f"build.log lists no kernel of {sources}")
    for mangled, info in sorted(found.items(),
                                key=lambda x: (x[1]["source"], x[0])):
        label = _kernel_label(mangled, info["source"])
        print(f"[ptxas] {info['source']} {label}: "
              f"{info.get('registers', '?')} registers, "
              f"{info.get('smem', '?')} bytes static smem, spill stores "
              f"{info.get('spill_stores', '?')} B, spill loads "
              f"{info.get('spill_loads', '?')} B")


def print_sass(card: str) -> None:
    """A hash of the SASS of each kernel of the two fused probes' sources, of
    the tensor-core forwards #1 and #2 (their narrow body, which #6 shares, and
    their wide one), of the kernels
    on mma_tile.cuh's tile (#5, #7, #8), which #6 and #9 share, and
    of the attention backwards' passes #3 and #4, in the built library
    (``cuobjdump``; the name line left out, the anonymous namespace's
    per-file tag blanked, the branch labels renumbered per kernel and the
    column padding collapsed), so two trees' device code can be
    compared, with each kernel's read-only loads (LDG.E...CONSTANT): the
    projecting forward's kernels read back slabs that their own block
    wrote, so none of them may have one."""
    import hashlib
    import re

    from commu_tpu_torch.ops import _build

    sass = subprocess.run(
        [str(Path(_build._nvcc()).parent / "cuobjdump"), "-sass",
         str(_build._library_path())], capture_output=True, text=True,
        check=True).stdout
    probe_kernels = ("rel_attention_proj_fwd", "proj_weights_kernel",
                     "proj_weights_wide_kernel", "OOut",
                     "DvecOut", "pad_matrix_kernel", "rel_attention_mem_fwd_kernel",
                     "rel_attention_fwd_mma_kernel", "rel_attention_mem_fwd_wide_kernel",
                     "rel_attention_fwd_wide_kernel", "project_mem_kv_kernel",
                     "kv_product_kernel", "kv_weights_kernel", "dw_sums_kernel",
                     "H1Out", "Z2Out", "Dh1Out", "DaOut", "bwd_keys_kernel",
                     "bwd_queries_kernel", "bias_grad_kernel", "bwd_rows_kernel",
                     "bwd_keys_wide_kernel", "bwd_queries_split_kernel",
                     "dq_finish_kernel", "bias_sums_kernel", "bias_rr_kernel")
    for block in re.split(r"\n\s*Function : ", sass)[1:]:
        name, body = block.split("\n", 1)
        name = name.strip()
        if not any(k in name for k in probe_kernels):
            continue
        source = ("sums.cu" if "_sums_cu_" in name else
                  "rel_attention_mem_bwd.cu" if "mem_bwd_cu" in name else
                  "rel_attention_bwd.cu" if "attention_bwd_cu" in name else
                  "project_mem_kv.cu" if "project_mem_kv" in name else
                  "rel_attention_proj_fwd.cu" if "proj" in name else
                  "rel_attention_mem_fwd.cu" if "mem_fwd" in name else
                  "rel_attention_fwd.cu" if "attention_fwd" in name else
                  "ffn_block_bwd.cu" if re.search("DvecOut|Dh1Out|DaOut", name)
                  else "ffn_block_fwd.cu" if re.search("OOut|H1Out|Z2Out", name)
                  else "ffn_pad.cuh")
        body = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", body)
        # branch labels are numbered across the whole file, and the columns
        # padded to the file's longest instruction: renumber the labels in
        # order of appearance and collapse the padding, so another kernel
        # of the file moves no hash
        labels = {}
        body = re.sub(r"\.L_x_\d+", lambda m: labels.setdefault(
            m.group(), f".L_{len(labels)}"), body)
        body = "\n".join(" ".join(line.split()) for line in body.splitlines())
        nc = sum(1 for line in body.splitlines()
                 if "LDG" in line and ".CONSTANT" in line)
        wgmma = re.search(r"kv_product_kernel|dw_sums_kernel", name)
        tensor = (f", {body.count('HGMMA')} HGMMA, {body.count('UTMALDG')} "
                  f"UTMALDG" if wgmma else "")
        print(f"[sass] {source} {_kernel_label(name, source)}: sha1 "
              f"{hashlib.sha1(body.encode()).hexdigest()[:16]} "
              f"({body.count(';')} instructions, {nc} read-only loads"
              f"{tensor}) [{card}]")
        if wgmma and not ("HGMMA" in body and "UTMALDG" in body):
            raise AssertionError(f"{name}: the warpgroup product without "
                                 "HGMMA or UTMALDG in its SASS")
        if source == "rel_attention_proj_fwd.cu" and nc:
            raise AssertionError(f"{name}: {nc} loads on the read-only path "
                                 "in a kernel that reads back its own "
                                 "writes")


def _nbytes(*tensors) -> int:
    """Bytes of these tensors: what a kernel must move for them, each read
    or written once."""
    return sum(t.numel() * t.element_size() for t in tensors)


def _entry(name, err, ms, plain_ms, shape, tol, nbytes, flops,
           library_ms=None, int8_ops=0, tf32_ops=0, bf16_ops=0,
           fma_flops=None):
    """One kernel's row of the result line (printed too: a later phase may
    replace an earlier phase's row of the same kernel).  ``nbytes``: its inputs read
    once and its outputs written once; ``flops``: the operations of the
    function on these inputs (attention: only the unmasked scores).
    The bound is the larger of bytes over the memory rate and operations
    over the rate of their type: ``flops`` at the f32 rate, ``int8_ops``
    (an int8 form's integer product) at the dense int8 tensor-core rate,
    ``tf32_ops`` and ``bf16_ops`` (tensor-core products) at the dense TF32
    and bf16 rates.  ``fma_flops``: a redesigned kernel's operations as its
    first design ran them (every product but an int8 one at the f32 rate),
    whose bound is printed beside the new one on the ``[bound]`` line (not
    in the row) so the table's rows stay comparable."""
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * (flops / F32_FLOPS_PER_S + int8_ops / INT8_OPS_PER_S
                   + tf32_ops / TF32_FLOPS_PER_S + bf16_ops / BF16_FLOPS_PER_S)
    by = "bytes" if t_bytes >= t_ops else "operations"
    lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
    left = ", masked scores left out" if "attention" in name else ""
    label = shape if shape.startswith(name) else f"{name} {shape}"
    extra = "".join(f", {n} {kind} operations at {rate:.4g}/s"
                    for n, kind, rate in ((int8_ops, "int8", INT8_OPS_PER_S),
                                          (tf32_ops, "TF32", TF32_FLOPS_PER_S),
                                          (bf16_ops, "bf16", BF16_FLOPS_PER_S))
                    if n)
    fma = ""
    if fma_flops is not None:
        fma_ms = max(t_bytes, 1e3 * (fma_flops / F32_FLOPS_PER_S
                                     + int8_ops / INT8_OPS_PER_S))
        fma = f" fma_rate_bound={fma_ms:.4f} ms"
    print(f"[bound] {label}: kernel={ms:.4f} ms plain={plain_ms:.4f} ms "
          f"bound={max(t_bytes, t_ops):.4f} ms by {by} ({nbytes} bytes, "
          f"{flops} operations{left}{extra}){fma} library={lib}")
    return {"max_abs_err": err, "tol": tol, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": by,
            "library_ms": library_ms, "shape": shape}


def _live(mask, reset, m_cap=0):
    """What this run's mask leaves to compute, summed over the batch rows:
    the unmasked (i, j) scores of mask [2, T, K] (plane 1 for reset rows,
    whose memory columns are all blocked), and the memory columns that some
    query sees."""
    live = mask.float() > -1e30
    rows = reset.long()
    return (int(live.sum((1, 2))[rows].sum()),
            int(live[:, :, :m_cap].any(1).sum(1)[rows].sum()))


def _attention_flops(b, h, dh, t, f2, pairs) -> int:
    """Forward, per head: qw^T k and P v (2 dh each) and phi psi (2 2F) per
    unmasked score (``pairs``, over the batch), u = qr^T W_r (2 T dh 2F) per
    row.  Masked scores, a reset row's memory keys among them, are left
    out."""
    return h * (pairs * (4 * dh + 2 * f2) + b * 2 * t * dh * f2)


def _attention_bwd_flops(b, h, dh, t, f2, d_model, pairs, mem_cols) -> int:
    """Backward from the saved scores, per head: dP, dv, dk and k ds^T
    (2 dh each) and ds psi^T (2 2F) per unmasked score, W_r du^T and qr du
    (2 T 2F dh each) per row; dWk and dWv (2 H dh D each) per memory column
    that some query sees."""
    return (h * (pairs * (8 * dh + 2 * f2) + b * 4 * t * f2 * dh)
            + 4 * mem_cols * h * dh * d_model)


def _matmul_kv(mem, layer, wk2, wv2):
    """The library yardstick of ``project_mem_kv``: one ``torch.matmul`` of
    both weights, joined along their outputs outside the timed call, with
    the layer's slabs, [2 H dh, D] x [R, B, D, Tb] -> [R, B, 2 H dh, Tb]
    (k over v; the kernel's [B, R, ...] outputs are a permute away).  It
    runs as one batched product and copies neither operand."""
    import torch

    w_cat = torch.cat([wk2.t(), wv2.t()]).contiguous()
    return lambda: torch.matmul(w_cat, mem[layer])


def _matmul_dw_mem(mem, layer, hd, dtype):
    """The library yardstick of #4's dWk + dWv batch sums: one
    ``torch.matmul`` of the layer's slabs against dk_mem and dv_mem stacked,
    [D, B M] x [B M, 2 H dh] -> [D, 2 H dh].  Both operands are laid out
    outside the timed call (the slabs permuted to [D, B M], the stacked
    gradient drawn at random in ``dtype``, as the bf16 sums round it)."""
    import torch

    r_blocks, b, d, tb = mem.shape[1:]
    x = mem[layer].permute(2, 1, 0, 3).reshape(d, b * r_blocks * tb)
    x = x.contiguous()
    gen = torch.Generator(device=mem.device).manual_seed(hd)
    a = torch.randn(b * r_blocks * tb, 2 * hd, generator=gen,
                    device=mem.device).to(dtype)
    return lambda: torch.matmul(x, a)


def _tensor_core_ops(dtype, products) -> dict:
    """The tensor-core operations of a kernel whose products run on
    ``mma.sync`` (``project_mem_kv``, the attention and FFN backwards), for
    ``products`` multiply-adds x 2: three TF32 passes in float32, one bf16
    pass in bfloat16 (the ``_entry`` keywords)."""
    import torch

    if dtype == torch.float32:
        return {"tf32_ops": 3 * products}
    return {"bf16_ops": products}


def _mma_fwd_ops(dtype, products, int8_ops=0) -> dict:
    """The ``_entry`` keywords of a kernel whose products run on
    ``mma.sync`` (#2, #7, #6, #9): ``products`` (multiply-adds x 2) at
    the tensor-core rate of ``dtype``, ``int8_ops`` at the int8 rate, and
    the first designs' count, every product but the int8 one on FMA."""
    return dict(flops=0, int8_ops=int8_ops, fma_flops=products,
                **_tensor_core_ops(dtype, products))


def _attention_fwd_ops(dtype, b, h, dh, t, f2, pairs, int8=False) -> dict:
    """``_mma_fwd_ops`` of the attention forwards (#2, and #1), at every
    width (their bound is the function's, not their design's): qw^T k and
    P v (2 dh each) and, in the float form, phi psi (2 2F) per unmasked
    score, and u = qr^T W_r (2 T dh 2F per row, a product in ``dtype`` with
    f32 sums in the reference, though the kernels run it on FMA to keep
    phi_q's bits), at the tensor-core rate of ``dtype``; the int8 form's
    phi_q psi_q at the int8 rate.  The same total as
    ``_attention_flops``."""
    bd = h * pairs * 2 * f2
    return _mma_fwd_ops(dtype, h * pairs * 4 * dh + (0 if int8 else bd)
                        + h * b * 2 * t * dh * f2, bd if int8 else 0)


def _nll_ops(dtype, products, backward=False) -> dict:
    """The ``_entry`` keywords of the NLL kernels (#10, #11): ``products``
    (2 B T D V, the logits' multiply-adds x 2) on ``mma.sync``, 3xTF32 in
    float32 (three passes counted) and h e_hi + h e_lo in bfloat16 (two
    bf16 passes); the backward's dh and demb products run 3xTF32, but for
    demb's bf16 h, exact in TF32, which takes two passes.  ``fma_flops``:
    the first design's count, every product at the f32 rate."""
    import torch

    if dtype == torch.float32:
        ops = {"tf32_ops": (9 if backward else 3) * products}
    else:
        ops = {"bf16_ops": 2 * products, "tf32_ops": 5 * products * backward}
    return dict(flops=0, fma_flops=(3 if backward else 1) * products, **ops)


def _nll_library(hidden, emb, bias, targets, lse=None, dnll=None):
    """The NLL kernels' library yardsticks, at PyTorch's defaults (no TF32):
    for #10 one ``torch.matmul`` of emb with the hidden state for the
    [B, V, T] logits, ``torch.logsumexp`` and a gather; for #11 (``lse``
    and ``dnll`` given) the same logits, the elementwise dlogits and the
    three products of the plain twin (dh, demb by ``torch.einsum``)."""
    import torch

    v = emb.shape[0]
    idx = targets.clamp(0, v - 1).long()[:, None, :]

    def forward():
        logits = torch.matmul(emb, hidden.float()) + bias[:, None]
        return torch.logsumexp(logits, dim=1) - logits.gather(1, idx)[:, 0]

    minus = -torch.ones(idx.shape, device=emb.device)

    def backward():
        h = hidden.float()
        logits = torch.matmul(emb, h) + bias[:, None]
        dl = torch.exp(logits - lse[:, None]).scatter_add_(1, idx, minus)
        dl = dl * dnll[:, None]
        return (torch.matmul(emb.t(), dl).to(hidden.dtype),
                torch.einsum("bvt,bdt->vd", dl, h), dl.sum(dim=(0, 2)))
    return forward if lse is None else backward


def _rerun_equal(name, run) -> None:
    """``run()`` -> tensors: a second call gives the same bits."""
    import torch

    first, again = run(), run()
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(first, again)):
        raise AssertionError(f"{name}: two runs on the same inputs differ")


def _compare(name, ours, ref, tol) -> float:
    import torch

    torch.cuda.synchronize()
    err = (ours.float() - ref.float()).abs()
    bound = tol + tol * ref.float().abs()
    if not torch.isfinite(ours.float()).all() or bool((err > bound).any()):
        raise AssertionError(f"{name}: max abs err {err.max().item():.3e} "
                             f"exceeds atol=rtol={tol}")
    return err.max().item()


def check_kernels(card: str) -> dict:
    """Phase 1: every kernel against its plain twin at the path's shapes."""
    import torch

    from commu_tpu_torch.ops import fused_attention as fa
    from commu_tpu_torch.ops import fused_ffn, layout

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    d_model, heads, d_ff = 500, 10, 1000
    dh = d_model // heads
    scale = 1.0 / dh ** 0.5
    results = {}

    def randn(*shape, std=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        for g in (1, 8):
            for t in (11, 128):
                q, k, v = (randn(g, heads, dh, t, dtype=dtype) for _ in range(3))
                w_r = fa.pack_r_kernel(randn(d_model, d_model, std=0.05),
                                       heads).to(dtype)
                rwbs, rrbs = fa._scaled_biases(randn(heads, dh, std=0.1),
                                               randn(heads, dh, std=0.1),
                                               scale, dtype)
                trig_a = fa.query_trig_table(t, 0, d_model, dtype, dev)
                psi = fa.key_trig_basis(t, d_model, dtype, dev)
                mask = fa.build_mask_bias(t, 0, 0, 0, False, device=dev)
                reset = (torch.arange(g, device=dev) % 3 == 1).int()
                args = (q, rwbs, rrbs, k, v, w_r, trig_a, psi, mask, reset,
                        scale)
                err = _compare(f"rel_attention_fwd G={g} T={t} {dtype}",
                               fa.rel_attention_fwd(*args),
                               fa.rel_attention_fwd_plain(*args), tol)
                ms = _cuda_ms(lambda: fa.rel_attention_fwd(*args))
                plain_ms = _cuda_ms(lambda: fa.rel_attention_fwd_plain(*args))
                print(f"[kernel] rel_attention_fwd G={g} T={t} {dtype}: "
                      f"max_abs_err={err:.3e} (atol=rtol={tol}) "
                      f"kernel={ms:.4f} ms plain={plain_ms:.4f} ms [{card}]")
                if (g, t, dtype) == (8, 11, torch.float32):
                    results["rel_attention_fwd"] = _entry(
                        "rel_attention_fwd", err, ms, plain_ms, "G=8 T=11 float32",
                        f"atol=rtol={tol}",
                        _nbytes(*args[:-1], q),
                        **_attention_fwd_ops(dtype, g, heads, dh, t,
                                             w_r.shape[2],
                                             _live(mask, reset)[0]))

        g, t = 8, 11
        x, o = randn(g, d_model, t, dtype=dtype), randn(g, d_model, t, dtype=dtype)
        w1 = randn(d_model, d_ff, std=0.05, dtype=dtype)
        w2 = randn(d_ff, d_model, std=0.05, dtype=dtype)
        b1 = randn(d_ff, std=0.1)
        b2, be1, be2 = (randn(d_model, std=0.1) for _ in range(3))
        g1, g2 = (1.0 + randn(d_model, std=0.1) for _ in range(2))
        args = (x, o, w1, b1, w2, b2, g1, be1, g2, be2)
        err = _compare(f"ffn_block_fwd G={g} T={t} {dtype}",
                       fused_ffn.ffn_block_fwd(*args),
                       fused_ffn.ffn_block_fwd_plain(*args), tol)
        ms = _cuda_ms(lambda: fused_ffn.ffn_block_fwd(*args))
        plain_ms = _cuda_ms(lambda: fused_ffn.ffn_block_fwd_plain(*args))
        print(f"[kernel] ffn_block_fwd G={g} T={t} {dtype}: "
              f"max_abs_err={err:.3e} (atol=rtol={tol}) "
              f"kernel={ms:.4f} ms plain={plain_ms:.4f} ms [{card}]")
        if dtype == torch.float32:
            results["ffn_block_fwd"] = _entry(
                "ffn_block_fwd", err, ms, plain_ms, "G=8 T=11 float32", f"atol=rtol={tol}",
                _nbytes(*args, x), **_mma_fwd_ops(dtype, 4 * d_model * d_ff * g * t))

        n_layers, g = 6, 8
        for m_cap in (1152, 4096):
            k, v = (randn(n_layers, g, heads, dh, m_cap, dtype=dtype)
                    for _ in range(2))
            k_self, v_self = (randn(n_layers, g, heads, dh, dtype=dtype)
                              for _ in range(2))
            length = torch.tensor([0, 127, 128, 500, m_cap - 1, m_cap,
                                   m_cap - 1, 3], dtype=torch.int32, device=dev)
            advance = torch.tensor([1, 1, 0, 1, 1, 1, 0, 1], dtype=torch.bool,
                                   device=dev)
            kk, vk, kp, vp = k.clone(), v.clone(), k.clone(), v.clone()
            layout.cache_append(kk, vk, k_self, v_self, length, advance)
            layout.cache_append_plain(kp, vp, k_self, v_self, length, advance)
            torch.cuda.synchronize()
            if not (torch.equal(kk, kp) and torch.equal(vk, vp)):
                raise AssertionError(f"cache_append M={m_cap} {dtype}: "
                                     "kernel and plain differ")
            if torch.equal(kk, k):
                raise AssertionError("cache_append wrote nothing")
            err = (kk.float() - kp.float()).abs().max().item()
            ms = _cuda_ms(lambda: layout.cache_append(
                kk, vk, k_self, v_self, length, advance))
            plain_ms = _cuda_ms(lambda: layout.cache_append_plain(
                kp, vp, k_self, v_self, length, advance))
            print(f"[kernel] cache_append L={n_layers} G={g} M={m_cap} {dtype}: "
                  f"max_abs_err={err:.3e} (exact) kernel={ms:.4f} ms "
                  f"plain={plain_ms:.4f} ms [{card}]")
            if (m_cap, dtype) == (4096, torch.float32):
                # the library yardstick: one slab copy_ per cache (every row
                # at one position, which the kernel's per-row lengths
                # generalise)
                def slab_copy():
                    kp[..., 77].copy_(k_self)
                    vp[..., 77].copy_(v_self)
                results["cache_append"] = _entry(
                    "cache_append", err, ms, plain_ms, "L=6 G=8 M=4096 float32", "exact",
                    2 * _nbytes(k_self, v_self) + _nbytes(length, advance), 0,
                    _cuda_ms(slab_copy))
    return results


def check_eval_kernels(card: str) -> dict:
    """Phase 1b: the eval path's kernels against their plain twins at the
    eval shape: ModelConfig() width, B = 10, T = 128, a ring of R = 16 slabs
    of 128 (M = 2048), L + 1 = 7 streams, vocabulary 729."""
    import torch

    from commu_tpu_torch.ops import fused_attention as fa
    from commu_tpu_torch.ops import fused_ffn, fused_nll, layout

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    d_model, heads, d_ff, vocab = 500, 10, 1000, 729
    dh = d_model // heads
    b, t, r_blocks, streams = 10, 128, 16, 7
    m_cap = r_blocks * t
    scale = 1.0 / dh ** 0.5
    results = {}

    def randn(*shape, std=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    def report(name, shape, dtype, err, tol, ms, plain_ms, nbytes, flops=0,
               library=None, **ops):
        print(f"[kernel] {name} {shape} {dtype}: max_abs_err={err:.3e} "
              f"({tol}) kernel={ms:.4f} ms plain={plain_ms:.4f} ms [{card}]")
        row = None
        if dtype == torch.float32 or "fma_flops" in ops:  # bf16 bounds too
            row = _entry(
                name, err, ms, plain_ms,
                f"{shape} {str(dtype).split('.')[-1]}", tol, nbytes, flops,
                _cuda_ms(library) if library is not None else None, **ops)
        if dtype == torch.float32:
            results[name] = row

    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        tol_s = f"atol=rtol={tol}"
        mem = randn(streams, r_blocks, b, d_model, t, dtype=dtype)
        wk, wv = (randn(d_model, heads, dh, std=0.05) for _ in range(2))
        k_mem, v_mem = fa.project_mem_kv(mem, 3, wk, wv)
        wk2, wv2 = (w.reshape(d_model, -1).to(dtype) for w in (wk, wv))
        kp, vp = fa.project_mem_kv_plain(mem, 3, wk2, wv2)
        err = max(_compare(f"project_mem_kv {dtype}", k_mem.reshape(kp.shape),
                           kp, tol),
                  _compare(f"project_mem_kv {dtype}", v_mem.reshape(vp.shape),
                           vp, tol))
        _rerun_equal(f"project_mem_kv {dtype}",
                     lambda: fa.project_mem_kv(mem, 3, wk, wv))
        report("project_mem_kv", "L+1=7 layer=3 B=10 R=16 Tb=128", dtype, err,
               tol_s + ", two runs bit-equal",
               _cuda_ms(lambda: fa.project_mem_kv(mem, 3, wk, wv)),
               _cuda_ms(lambda: fa.project_mem_kv_plain(mem, 3, wk2, wv2)),
               _nbytes(mem[3], wk2, wv2, k_mem, v_mem), 0,
               _matmul_kv(mem, 3, wk2, wv2),
               **_tensor_core_ops(dtype, 4 * d_model * heads * dh * b * m_cap))

        q, k_win, v_win = (randn(b, heads, dh, t, dtype=dtype)
                           for _ in range(3))
        w_r = fa.pack_r_kernel(randn(d_model, d_model, std=0.05),
                               heads).to(dtype)
        rwbs, rrbs = fa._scaled_biases(randn(heads, dh, std=0.1),
                                       randn(heads, dh, std=0.1), scale, dtype)
        trig_a = fa.query_trig_table(t, m_cap, d_model, dtype, dev)
        reset = (torch.arange(b, device=dev) == 3).int()
        for count, head in ((0, 0), (1024, 1024), (m_cap, 640)):
            psi = fa.ring_psi(fa.key_trig_basis(m_cap + t, d_model, dtype, dev),
                              t, count, head)
            mask = fa.build_mask_bias(t, m_cap, count, head, True, device=dev)
            args = (q, rwbs, rrbs, k_mem, k_win, v_mem, v_win, w_r, trig_a,
                    psi, mask, reset, scale)
            shape = f"B=10 T=128 M=2048 count={count} head={head}"
            err = _compare(f"rel_attention_mem_fwd {shape} {dtype}",
                           fa.rel_attention_mem_fwd(*args),
                           fa.rel_attention_mem_fwd_plain(*args), tol)
            if count == m_cap:
                report("rel_attention_mem_fwd", shape, dtype, err, tol_s,
                       _cuda_ms(lambda: fa.rel_attention_mem_fwd(*args), 20),
                       _cuda_ms(lambda: fa.rel_attention_mem_fwd_plain(*args),
                                20), _nbytes(*args[:-1], q),
                       **_attention_fwd_ops(dtype, b, heads, dh, t,
                                            w_r.shape[2],
                                            _live(mask, reset)[0]))
            else:
                print(f"[kernel] rel_attention_mem_fwd {shape} {dtype}: "
                      f"max_abs_err={err:.3e} ({tol_s}) [{card}]")

        rows = randn(b, d_model, t, dtype=dtype)
        buf_k, buf_p = mem.clone(), mem.clone()
        layout.ring_write_layer(buf_k, rows, 5, 11)
        layout.ring_write_layer_plain(buf_p, rows, 5, 11)
        torch.cuda.synchronize()
        if not torch.equal(buf_k, buf_p) or torch.equal(buf_k, mem):
            raise AssertionError(f"ring_write_layer {dtype}: kernel and "
                                 "plain differ, or nothing was written")
        report("ring_write_layer", "L+1=7 R=16 B=10 D=500 Tb=128", dtype, 0.0,
               "exact", _cuda_ms(lambda: layout.ring_write_layer(
                   buf_k, rows, 5, 11)),
               _cuda_ms(lambda: layout.ring_write_layer_plain(
                   buf_p, rows, 5, 11)), 2 * _nbytes(rows), 0,
               lambda: buf_p[5, 11].copy_(rows))

        hidden = randn(b, d_model, t, dtype=dtype)
        emb, bias = randn(vocab, d_model, std=0.05), randn(vocab, std=0.1)
        targets = torch.randint(1, vocab, (b, t), generator=gen, device=dev,
                                dtype=torch.int32)
        targets[:, 100:] = 0  # PAD: scored like any other, masked later
        err = _compare(f"nll_fwd {dtype}",
                       fused_nll.nll_fwd(hidden, emb, bias, targets),
                       fused_nll.nll_fwd_plain(hidden, emb, bias, targets),
                       F32_TOL)
        _rerun_equal(f"nll_fwd {dtype}", lambda: (
            fused_nll.nll_fwd(hidden, emb, bias, targets),))
        report("nll_fwd", "B=10 D=500 T=128 V=729", dtype, err,
               f"atol=rtol={F32_TOL}, f32 logits, two runs bit-equal",
               _cuda_ms(lambda: fused_nll.nll_fwd(hidden, emb, bias, targets)),
               _cuda_ms(lambda: fused_nll.nll_fwd_plain(hidden, emb, bias,
                                                        targets)),
               _nbytes(hidden, emb, bias, targets) + 4 * b * t,
               library=_nll_library(hidden, emb, bias, targets),
               **_nll_ops(dtype, 2 * b * t * d_model * vocab))

        x, o = rows, randn(b, d_model, t, dtype=dtype)
        w1 = randn(d_model, d_ff, std=0.05, dtype=dtype)
        w2 = randn(d_ff, d_model, std=0.05, dtype=dtype)
        b1 = randn(d_ff, std=0.1)
        b2, be1, be2 = (randn(d_model, std=0.1) for _ in range(3))
        g1, g2 = (1.0 + randn(d_model, std=0.1) for _ in range(2))
        args = (x, o, w1, b1, w2, b2, g1, be1, g2, be2)
        err = _compare(f"ffn_block_fwd G=10 T=128 {dtype}",
                       fused_ffn.ffn_block_fwd(*args),
                       fused_ffn.ffn_block_fwd_plain(*args), tol)
        ms = _cuda_ms(lambda: fused_ffn.ffn_block_fwd(*args))
        plain_ms = _cuda_ms(lambda: fused_ffn.ffn_block_fwd_plain(*args))
        print(f"[kernel] ffn_block_fwd G=10 T=128 {dtype}: "
              f"max_abs_err={err:.3e} ({tol_s}) kernel={ms:.4f} ms "
              f"plain={plain_ms:.4f} ms [{card}]")
    return results


def _compare_scaled(name, ours, ref, tol) -> float:
    """A sum over many terms against its twin: |err| <= tol * max|ref| +
    tol * |ref|.  Returns the max abs error."""
    import torch

    torch.cuda.synchronize()
    ref = ref.float()
    err = (ours.float() - ref).abs()
    bound = tol * ref.abs().max().clamp(min=1e-30) + tol * ref.abs()
    if not torch.isfinite(ours.float()).all() or bool((err > bound).any()):
        raise AssertionError(f"{name}: max abs err {err.max().item():.3e} "
                             f"exceeds {tol} x max|ref| "
                             f"({ref.abs().max().item():.3e})")
    return err.max().item()


def _seed_checks(name, run) -> None:
    """``run(seed)`` -> tensors: a rerun from one seed gives the same bits,
    a second seed gives other masks."""
    import torch

    first, again, other = (run(DROPOUT_SEED), run(DROPOUT_SEED),
                           run(DROPOUT_SEED + 1))
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(first, again)):
        raise AssertionError(f"{name}: two runs from one seed differ")
    if all(torch.equal(x, y) for x, y in zip(first, other)):
        raise AssertionError(f"{name}: a second seed changed nothing")


def _check_keep_rate(name, rate, want=KEEP_RATE, within=0.002) -> float:
    if not abs(rate - want) <= within:
        raise AssertionError(f"{name}: keep rate {rate:.5f} on the card, "
                             f"expected {want:.5f} +- {within}")
    return rate


INT8_TOL = ("all but 2e-3 of the elements within {tol} x (max|ref| + |ref|), "
            "none beyond {far} x max|ref| (a tie of the quantiser's rounding "
            "falls one step apart)")


def _compare_int8(name, ours, ref, tol) -> float:
    """An int8 form against its twin.  The integer sums are exact on both
    sides, but the kernel's float operand (phi, ds) differs from the twin's
    in its last bits, so a value on a rounding tie quantises one step apart:
    ``INT8_TOL``.  Returns the max abs error."""
    import torch

    torch.cuda.synchronize()
    ref = ref.float()
    top = float(ref.abs().max().clamp(min=1e-30))
    err = (ours.float() - ref).abs()
    off = int((err > tol * (top + ref.abs())).sum())
    far = max(20 * tol, 5e-3)
    if not torch.isfinite(ours.float()).all() \
            or off > max(2e-3 * err.numel(), 8) or float(err.max()) > far * top:
        raise AssertionError(
            f"{name}: {off} of {err.numel()} elements beyond {tol} x "
            f"(max|ref| + |ref|), max abs err {float(err.max()):.3e} "
            f"(max|ref| {top:.3e})")
    return float(err.max())


def _report_kernel(results, card, name, what, shape, dtype, err, tol, fn,
                   plain, iters=3, nbytes=0, flops=0, library=None,
                   int8_ops=0, bound_bf16=False, **ops) -> None:
    """Time a kernel and its plain twin and print the ``[kernel]`` line; in
    float32, with ``nbytes`` given, print the ``[bound]`` line too and, with
    a ``name``, keep the row for the result line (a row without a name is
    another shape or dropout setting of a kernel that has its row).  With
    ``bound_bf16`` a bfloat16 call prints its ``[bound]`` line too (no
    row)."""
    import torch

    ms, plain_ms = _cuda_ms(fn, iters, 1), _cuda_ms(plain, iters, 1)
    print(f"[kernel] {what} {shape} {dtype}: max_abs_err={err:.3e} "
          f"({tol}) kernel={ms:.4f} ms plain={plain_ms:.4f} ms [{card}]")
    if (name or nbytes) and (dtype == torch.float32 or bound_bf16):
        row = _entry(name or what.split()[0], err, ms, plain_ms,
                     f"{what}, {shape} {str(dtype).split('.')[-1]}", tol,
                     nbytes, flops,
                     _cuda_ms(library, iters, 1) if library else None,
                     int8_ops, **ops)
        if name and dtype == torch.float32:
            results[name] = row


def check_train_kernels(card: str) -> dict:
    """Phase 1c: the training path's backward kernels and the forward
    kernels' save outputs against their plain twins at the training shape:
    ModelConfig() width, B = 256, T = 128, a full ring of R = 8 slabs of 128
    (M = 1024), L + 1 = 7 streams, F = 1000, vocabulary 729, f32 and bf16;
    without dropout, then at p = 0.1 from a fixed seed (the rows of the
    result line: the training path runs the kernels so), and the dropout
    kernel.  The twins' [B, H, T, K] planes fit the card at B = 256, so no
    cut.  A backward's weight gradients are sums over B x T or B x M terms,
    so they are held at tol x max|ref|.  Each mask's realised keep rate is
    read off the card through inputs that make an output show the mask."""
    import torch

    from commu_tpu_torch.ops import dropout, embed
    from commu_tpu_torch.ops import fused_attention as fa
    from commu_tpu_torch.ops import fused_ffn, fused_nll, prng

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    d_model, heads, d_ff, vocab = 500, 10, 1000, 729
    dh = d_model // heads
    b, t, r_blocks, streams = 256, 128, 8, 7
    m_cap = r_blocks * t
    scale = 1.0 / dh ** 0.5
    shape = "B=256 T=128 M=1024 D=500 F=1000 V=729"
    drop = dict(seed=DROPOUT_SEED, dropout_p=DROPOUT_P)
    results = {}

    def randn(*shape, std=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    def report(name, what, dtype, *args, **kwargs):
        _report_kernel(results, card, name, what, shape, dtype, *args,
                       **kwargs)

    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        scaled = f"{tol} x max|ref| per output"
        # attention over a full ring, head at slab 2, reset rows
        mem = randn(streams, r_blocks, b, d_model, t, dtype=dtype)
        wk, wv = (randn(d_model, heads, dh, std=0.05) for _ in range(2))
        k_mem, v_mem = fa.project_mem_kv(mem, 2, wk, wv)
        wk2, wv2 = (w.reshape(d_model, -1).to(dtype) for w in (wk, wv))
        kp, vp = fa.project_mem_kv_plain(mem, 2, wk2, wv2)
        err = max(_compare(f"project_mem_kv {dtype}", k_mem.reshape(kp.shape),
                           kp, tol),
                  _compare(f"project_mem_kv {dtype}", v_mem.reshape(vp.shape),
                           vp, tol))
        del kp, vp
        _rerun_equal(f"project_mem_kv {dtype}",
                     lambda: fa.project_mem_kv(mem, 2, wk, wv))
        report("project_mem_kv", "project_mem_kv L+1=7 layer=2 R=8", dtype,
               err, f"atol=rtol={tol}, two runs bit-equal",
               lambda: fa.project_mem_kv(mem, 2, wk, wv),
               lambda: fa.project_mem_kv_plain(mem, 2, wk2, wv2),
               nbytes=_nbytes(mem[2], wk2, wv2, k_mem, v_mem),
               library=_matmul_kv(mem, 2, wk2, wv2), bound_bf16=True,
               **_tensor_core_ops(dtype, 4 * d_model * heads * dh * b * m_cap))
        report_dw_sums(card, dtype, d_model, heads * dh, b, m_cap)
        q, k_win, v_win = (randn(b, heads, dh, t, dtype=dtype)
                           for _ in range(3))
        w_r = fa.pack_r_kernel(randn(d_model, d_model, std=0.05),
                               heads).to(dtype)
        f2 = w_r.shape[2]
        rwbs, rrbs = fa._scaled_biases(randn(heads, dh, std=0.1),
                                       randn(heads, dh, std=0.1), scale, dtype)
        psi = fa.ring_psi(fa.key_trig_basis(m_cap + t, d_model, dtype, dev), t,
                          m_cap, 256)
        fwd = (q, rwbs, rrbs, k_mem, k_win, v_mem, v_win, w_r,
               fa.query_trig_table(t, m_cap, d_model, dtype, dev), psi,
               fa.build_mask_bias(t, m_cap, m_cap, 256, False, device=dev),
               (torch.arange(b, device=dev) % 50 == 7).int(), scale)
        dout = randn(b, heads, dh, t, dtype=dtype)
        pairs, mem_cols = _live(fwd[10], fwd[11], m_cap)
        for kw, tag in (({}, ""), (drop, " dropout 0.1")):
            out, s_res, lse = fa.rel_attention_mem_fwd(*fwd, save=True, **kw)
            ref = fa.rel_attention_mem_fwd_plain(*fwd, save=True, **kw)
            live = ref[1] > -1e30  # masked scores sit at NEG_INF in both
            if not torch.equal(live, s_res > -1e30):
                raise AssertionError(f"rel_attention_mem_fwd save {dtype}: "
                                     "masks differ")
            err = max(_compare("rel_attention_mem_fwd out" + tag, out, ref[0],
                               tol),
                      _compare_scaled("rel_attention_mem_fwd S" + tag,
                                      s_res[live], ref[1][live], tol),
                      _compare_scaled("rel_attention_mem_fwd lse" + tag, lse,
                                      ref[2], tol))
            del ref, live
            report("rel_attention_mem_fwd" if kw else None,
                   "rel_attention_mem_fwd save=True (out, S, lse)" + tag,
                   dtype, err, scaled,
                   lambda: fa.rel_attention_mem_fwd(*fwd, save=True, **kw),
                   lambda: fa.rel_attention_mem_fwd_plain(*fwd, save=True,
                                                          **kw),
                   nbytes=_nbytes(*fwd[:-1], out, s_res, lse),
                   bound_bf16=bool(kw),
                   **_attention_fwd_ops(dtype, b, heads, dh, t, f2, pairs))
            bwd = (q, rwbs, rrbs, k_mem, k_win, v_mem, v_win, mem, 2, w_r,
                   fwd[8], psi, s_res, lse, out, dout, scale)
            ours = fa.rel_attention_mem_bwd(*bwd, **kw)
            err = 0.0
            for o, p, name in zip(ours,
                                  fa.rel_attention_mem_bwd_plain(*bwd, **kw),
                                  ("dq", "dk_win", "dv_win", "dWk", "dWv",
                                   "dW_r", "d r_w_bias", "d r_r_bias")):
                err = max(err, _compare_scaled(
                    f"rel_attention_mem_bwd {name}{tag} {dtype}", o, p, tol))
            again = fa.rel_attention_mem_bwd(*bwd, **kw)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(ours, again)):
                raise AssertionError("rel_attention_mem_bwd: two runs differ")
            report("rel_attention_mem_bwd" if kw else None,
                   "rel_attention_mem_bwd (two runs bit-equal)" + tag, dtype,
                   err, scaled,
                   lambda: fa.rel_attention_mem_bwd(*bwd, **kw),
                   lambda: fa.rel_attention_mem_bwd_plain(*bwd, **kw),
                   nbytes=_nbytes(q, rwbs, rrbs, k_mem, k_win, v_mem, v_win,
                                  mem[2], w_r, fwd[8], psi, s_res, lse, out,
                                  dout, *ours), bound_bf16=bool(kw),
                   **_tensor_core_ops(dtype, _attention_bwd_flops(
                       b, heads, dh, t, f2, d_model, pairs, mem_cols)))
            del ours, again
        # the mask's own checks: seeds, and the keep rate on the card.  With
        # q and the biases at 0 a row's probabilities are uniform over its
        # n unmasked keys, and with v = 1 the output is kept / n x keep-scale
        _seed_checks(f"rel_attention_mem_fwd {dtype}", lambda seed: (
            fa.rel_attention_mem_fwd(*fwd, seed=seed, dropout_p=DROPOUT_P),))
        _seed_checks(f"rel_attention_mem_bwd {dtype}", lambda seed:
                     fa.rel_attention_mem_bwd(*bwd, seed=seed,
                                              dropout_p=DROPOUT_P)[:3])
        if dtype == torch.float32:
            zeros, ones = torch.zeros_like(q), torch.ones_like(v_win)
            probe = fa.rel_attention_mem_fwd(
                zeros, torch.zeros_like(rwbs), torch.zeros_like(rrbs), k_mem,
                k_win, torch.ones_like(v_mem), ones, w_r, fwd[8], psi, fwd[10],
                torch.zeros_like(fwd[11]), scale, **drop)
            n_keys = (m_cap + 1 + torch.arange(t, device=dev)).double()
            kept = (probe[:, :, 0].double() / prng.keep_scale_for(DROPOUT_P)
                    * n_keys).sum()
            rate = _check_keep_rate("attention mask", float(
                kept / (n_keys.sum() * b * heads)))
            print(f"[kernel] attention mask [T, K] x {b * heads} planes: keep "
                  f"rate on the card {rate:.5f} (expected {KEEP_RATE:.5f} "
                  f"+- 0.002) [{card}]")
            del zeros, ones, probe
        del mem, k_mem, v_mem, fwd, bwd, out, s_res, lse
        torch.cuda.empty_cache()

        # the FFN block
        w1 = randn(d_model, d_ff, std=0.05, dtype=dtype)
        w2 = randn(d_ff, d_model, std=0.05, dtype=dtype)
        g1, be1, g2, be2 = (1.0 + randn(d_model, std=0.1),
                            randn(d_model, std=0.1),
                            1.0 + randn(d_model, std=0.1),
                            randn(d_model, std=0.1))
        fwd = (randn(b, d_model, t, dtype=dtype),
               randn(b, d_model, t, dtype=dtype), w1, randn(d_ff, std=0.1),
               w2, randn(d_model, std=0.1), g1, be1, g2, be2)
        dy = randn(b, d_model, t, dtype=dtype)
        for kw, tag in (({}, ""), (drop, " dropout 0.1")):
            saved = fused_ffn.ffn_block_fwd(*fwd, save=True, **kw)
            err = 0.0
            for o, p in zip(saved, fused_ffn.ffn_block_fwd_plain(
                    *fwd, save=True, **kw)):
                err = max(err, _compare(f"ffn_block_fwd save{tag} {dtype}", o,
                                        p, tol))
            report("ffn_block_fwd" if kw else None,
                   "ffn_block_fwd save=True (y, norm1, norm2, h1, rstd)" + tag,
                   dtype, err, f"atol=rtol={tol}",
                   lambda: fused_ffn.ffn_block_fwd(*fwd, save=True, **kw),
                   lambda: fused_ffn.ffn_block_fwd_plain(*fwd, save=True,
                                                         **kw), 10,
                   nbytes=_nbytes(*fwd, *saved), bound_bf16=bool(kw),
                   **_mma_fwd_ops(dtype, 4 * d_model * d_ff * b * t))
            bwd = (w1, w2, g1, be1, g2, *saved[1:], dy)
            ours = fused_ffn.ffn_block_bwd(*bwd, **kw)
            err = 0.0
            for o, p, name in zip(ours,
                                  fused_ffn.ffn_block_bwd_plain(*bwd, **kw),
                                  ("dx", "do", "dW1", "db1", "dW2", "db2",
                                   "dg1", "dbe1", "dg2", "dbe2")):
                err = max(err, _compare_scaled(
                    f"ffn_block_bwd {name}{tag} {dtype}", o, p, tol))
            outs = ours if kw else ours[:1] + ours[2:]  # do is dx at p = 0
            report("ffn_block_bwd" if kw else None, "ffn_block_bwd" + tag,
                   dtype, err, scaled,
                   lambda: fused_ffn.ffn_block_bwd(*bwd, **kw),
                   lambda: fused_ffn.ffn_block_bwd_plain(*bwd, **kw), 10,
                   nbytes=_nbytes(*bwd, *outs), bound_bf16=True,
                   **_tensor_core_ops(dtype, 8 * d_model * d_ff * b * t))
        _seed_checks(f"ffn_block_fwd {dtype}", lambda seed: (
            fused_ffn.ffn_block_fwd(*fwd, seed=seed, dropout_p=DROPOUT_P),))
        _seed_checks(f"ffn_block_bwd {dtype}", lambda seed:
                     fused_ffn.ffn_block_bwd(*bwd, seed=seed,
                                             dropout_p=DROPOUT_P)[:2])
        # the three masks bit for bit: x = 0 and o = 1 leave z1 = mask O x
        # scale, so norm1 > 0 where kept; W1 = 0 and b1 = 1 leave h1 = 1, so
        # the saved h1 is +1 kept and -1 dropped; W2 = 0 and b2 = 1000 leave
        # z2 = a + mask F x 1000 x scale, so norm2 > 0 where kept
        one, zero = torch.ones(d_model, device=dev), torch.zeros(d_model,
                                                                 device=dev)
        probe = fused_ffn.ffn_block_fwd(
            torch.zeros_like(fwd[0]), torch.ones_like(fwd[0]),
            torch.zeros_like(w1), torch.ones(d_ff, device=dev),
            torch.zeros_like(w2), 1000.0 * one, one, zero, one, zero,
            save=True, **drop)
        for salt, rows, got in ((fused_ffn.SALT_O, d_model, probe[1] > 0),
                                (fused_ffn.SALT_H, d_ff, probe[3] > 0),
                                (fused_ffn.SALT_F, d_model, probe[2] > 0)):
            want = prng.keep_mask(prng.row_seeds(DROPOUT_SEED, b, 8192,
                                                 salt * 2048, device=dev),
                                  (rows, t), DROPOUT_P)
            if not torch.equal(got, want):
                raise AssertionError(f"ffn_block_fwd {dtype}: mask of salt "
                                     f"{salt} differs from keep_mask")
            rate = _check_keep_rate(f"FFN mask salt {salt}",
                                    float(got.double().mean()))
            print(f"[kernel] ffn_block_fwd {dtype} mask salt {salt} "
                  f"[{rows}, {t}] x {b}: equals keep_mask bit for bit, keep "
                  f"rate on the card {rate:.5f} (expected {KEEP_RATE:.5f} "
                  f"+- 0.002) [{card}]")
        del probe, saved, ours, outs, bwd

        # the activation dropout: forward, and its backward (the same pass
        # over the cotangent); kept values are x times the scale rounded to
        # the dtype, so kernel and twin agree exactly
        x = fwd[0]
        for salt in (dropout.SALT_EMB, dropout.SALT_OUT):
            leaf = x.clone().requires_grad_(True)
            y = dropout.dropout_bdt(leaf, DROPOUT_SEED, DROPOUT_P, salt)
            y.backward(dy)
            want = dropout.dropout_bdt_plain(x, DROPOUT_SEED, DROPOUT_P, salt)
            want_g = dropout.dropout_bdt_plain(dy, DROPOUT_SEED, DROPOUT_P,
                                               salt)
            torch.cuda.synchronize()
            if not (torch.equal(y.detach(), want)
                    and torch.equal(leaf.grad, want_g)):
                raise AssertionError(f"dropout_bdt salt {salt} {dtype}: kernel "
                                     "and plain differ")
            rate = _check_keep_rate(f"dropout_bdt salt {salt}", float(
                (dropout.dropout_bdt_apply(torch.ones_like(x), DROPOUT_SEED,
                                           DROPOUT_P, salt) != 0)
                .double().mean()))
            print(f"[kernel] dropout_bdt salt {salt} {dtype}: forward and "
                  f"backward equal the plain twin exactly, keep rate on the "
                  f"card {rate:.5f} (expected {KEEP_RATE:.5f} +- 0.002) "
                  f"[{card}]")
        _seed_checks(f"dropout_bdt {dtype}", lambda seed: (
            dropout.dropout_bdt_apply(x, seed, DROPOUT_P, dropout.SALT_EMB),))
        report("dropout_bdt", "dropout_bdt p=0.1", dtype, 0.0, "exact",
               lambda: dropout.dropout_bdt_apply(x, DROPOUT_SEED, DROPOUT_P,
                                                 dropout.SALT_EMB),
               lambda: dropout.dropout_bdt_plain(x, DROPOUT_SEED, DROPOUT_P,
                                                 dropout.SALT_EMB), 10,
               nbytes=2 * _nbytes(x), flops=14 * x.numel(),
               library=lambda: torch.nn.functional.dropout(x, DROPOUT_P,
                                                           training=True))
        del fwd, leaf, y, want, want_g

        # the tied-embedding NLL: f32 logits whatever the hidden dtype
        hidden = randn(b, d_model, t, dtype=dtype)
        emb, bias = randn(vocab, d_model, std=0.05), randn(vocab, std=0.1)
        targets = torch.randint(1, vocab, (b, t), generator=gen, device=dev,
                                dtype=torch.int32)
        targets[:, 100:] = 0
        nll, lse = fused_nll.nll_fwd(hidden, emb, bias, targets, save=True)
        ref = fused_nll.nll_fwd_plain(hidden, emb, bias, targets, save=True)
        err = max(_compare("nll_fwd save nll", nll, ref[0], F32_TOL),
                  _compare("nll_fwd save lse", lse, ref[1], F32_TOL))
        products = 2 * b * t * d_model * vocab
        report(None, "nll_fwd save=True (nll, lse)", dtype, err,
               f"atol=rtol={F32_TOL}",
               lambda: fused_nll.nll_fwd(hidden, emb, bias, targets, save=True),
               lambda: fused_nll.nll_fwd_plain(hidden, emb, bias, targets,
                                               save=True), 10,
               nbytes=_nbytes(hidden, emb, bias, targets, nll, lse),
               library=_nll_library(hidden, emb, bias, targets),
               bound_bf16=True, **_nll_ops(dtype, products))
        dnll = torch.where(targets != 0, randn(b, t), 0.0)
        bwd = (hidden, emb, bias, targets, lse, dnll)
        ours = fused_nll.nll_bwd(*bwd)
        err = 0.0
        for o, p, name in zip(ours, fused_nll.nll_bwd_plain(*bwd),
                              ("dh", "d(emb)", "d(bias)")):
            err = max(err, _compare_scaled(
                f"nll_bwd {name} {dtype}", o, p, tol if name == "dh"
                else F32_TOL))
        _rerun_equal(f"nll_bwd {dtype}", lambda: fused_nll.nll_bwd(*bwd))
        report("nll_bwd", "nll_bwd (two runs bit-equal)", dtype, err,
               f"{scaled} ({F32_TOL} for the f32 sums)",
               lambda: fused_nll.nll_bwd(*bwd),
               lambda: fused_nll.nll_bwd_plain(*bwd), 10,
               nbytes=_nbytes(*bwd, *ours),
               library=_nll_library(*bwd), bound_bf16=True,
               **_nll_ops(dtype, products, backward=True))

        # the embedding gradient: PAD inputs count
        tokens = torch.randint(0, vocab, (b, t), generator=gen, device=dev,
                               dtype=torch.int32)
        tokens[:, 110:] = 0
        g = randn(b, d_model, t, dtype=dtype)
        err = _compare_scaled(f"embed_grad {dtype}",
                              embed.embed_grad(tokens, g, d_model ** 0.5, vocab),
                              embed.embed_grad_plain(tokens, g, d_model ** 0.5,
                                                     vocab), F32_TOL)
        _rerun_equal(f"embed_grad {dtype}", lambda: (
            embed.embed_grad(tokens, g, d_model ** 0.5, vocab),))
        index = tokens.reshape(-1).long()
        report("embed_grad", "embed_grad", dtype, err,
               f"{F32_TOL} x max|ref| (f32 sums), two runs bit-equal",
               lambda: embed.embed_grad(tokens, g, d_model ** 0.5, vocab),
               lambda: embed.embed_grad_plain(tokens, g, d_model ** 0.5,
                                              vocab), 10,
               nbytes=_nbytes(tokens, g) + 4 * vocab * d_model,
               flops=2 * g.numel(),
               library=lambda: torch.zeros(
                   (vocab, d_model), device=dev).index_add_(
                       0, index, g.permute(0, 2, 1).reshape(-1, d_model)
                       .float() * d_model ** 0.5))
        torch.cuda.empty_cache()
    return results


def check_capacity0_and_probe_kernels(card: str) -> dict:
    """Phase 1d: the kernels of training without XL memory and of the two
    fused probes against their plain twins at the training shape
    (ModelConfig() width, B = 256, T = 128; a full ring of R = 8 slabs of 128
    for the projecting forward and the ring writes), f32 and bf16, without
    dropout and at p = 0.1 from a fixed seed: the no-memory forward's save
    outputs and its backward, the projecting forward (also against
    ``project_mem_kv`` followed by ``rel_attention_mem_fwd``, at the same
    tolerance), the
    fused-o form of the FFN kernels, ``ring_write`` and, for its time at
    this shape, ``ring_write_layer``.  The rows of the result line are the
    dropout 0.1 ones; every float32 row prints its bound."""
    import torch

    from commu_tpu_torch.ops import fused_attention as fa
    from commu_tpu_torch.ops import fused_ffn, layout, prng

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)
    d_model, heads, d_ff = 500, 10, 1000
    dh = d_model // heads
    hd = heads * dh
    b, t, r_blocks, streams = 256, 128, 8, 7
    m_cap = r_blocks * t
    scale = 1.0 / dh ** 0.5
    drop = dict(seed=DROPOUT_SEED, dropout_p=DROPOUT_P)
    results = {}

    def randn(*shape, std=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    def report(*args, **kwargs):
        _report_kernel(results, card, *args, **kwargs)

    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        scaled = f"{tol} x max|ref| per output"
        # ---- attention over the window alone, reset rows
        shape = "B=256 T=128 M=0 D=500"
        q, k, v, dout = (randn(b, heads, dh, t, dtype=dtype) for _ in range(4))
        w_r = fa.pack_r_kernel(randn(d_model, d_model, std=0.05),
                               heads).to(dtype)
        f2 = w_r.shape[2]
        rwbs, rrbs = fa._scaled_biases(randn(heads, dh, std=0.1),
                                       randn(heads, dh, std=0.1), scale, dtype)
        fwd = (q, rwbs, rrbs, k, v, w_r,
               fa.query_trig_table(t, 0, d_model, dtype, dev),
               fa.key_trig_basis(t, d_model, dtype, dev),
               fa.build_mask_bias(t, 0, 0, 0, False, device=dev),
               (torch.arange(b, device=dev) % 50 == 7).int(), scale)
        pairs = _live(fwd[8], fwd[9])[0]
        for kw, tag in (({}, ""), (drop, " dropout 0.1")):
            out, s_res, lse = fa.rel_attention_fwd(*fwd, save=True, **kw)
            ref = fa.rel_attention_fwd_plain(*fwd, save=True, **kw)
            live = ref[1] > -1e30  # masked scores sit at NEG_INF in both
            if not torch.equal(live, s_res > -1e30):
                raise AssertionError(f"rel_attention_fwd save {dtype}: masks "
                                     "differ")
            err = max(_compare("rel_attention_fwd out" + tag, out, ref[0],
                               tol),
                      _compare_scaled("rel_attention_fwd S" + tag,
                                      s_res[live], ref[1][live], tol),
                      _compare_scaled("rel_attention_fwd lse" + tag, lse,
                                      ref[2], tol))
            del ref, live
            report(None, "rel_attention_fwd save=True (out, S, lse)" + tag,
                   shape, dtype, err, scaled,
                   lambda: fa.rel_attention_fwd(*fwd, save=True, **kw),
                   lambda: fa.rel_attention_fwd_plain(*fwd, save=True, **kw),
                   nbytes=_nbytes(*fwd[:-1], out, s_res, lse),
                   bound_bf16=True,
                   **_attention_fwd_ops(dtype, b, heads, dh, t, f2, pairs))
            bwd = (q, rwbs, rrbs, k, v, w_r, fwd[6], fwd[7], s_res, lse, out,
                   dout, scale)
            ours = fa.rel_attention_bwd(*bwd, **kw)
            err = 0.0
            for o, pl, name in zip(ours, fa.rel_attention_bwd_plain(*bwd, **kw),
                                   ("dq", "dk", "dv", "dW_r", "d r_w_bias",
                                    "d r_r_bias")):
                err = max(err, _compare_scaled(
                    f"rel_attention_bwd {name}{tag} {dtype}", o, pl, tol))
            again = fa.rel_attention_bwd(*bwd, **kw)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(ours, again)):
                raise AssertionError("rel_attention_bwd: two runs differ")
            report("rel_attention_bwd" if kw else None,
                   "rel_attention_bwd (two runs bit-equal)" + tag, shape,
                   dtype, err, scaled,
                   lambda: fa.rel_attention_bwd(*bwd, **kw),
                   lambda: fa.rel_attention_bwd_plain(*bwd, **kw),
                   nbytes=_nbytes(*bwd[:-1], *ours), bound_bf16=bool(kw),
                   **_tensor_core_ops(dtype, _attention_bwd_flops(
                       b, heads, dh, t, f2, d_model, pairs, 0)))
            del ours, again
        _seed_checks(f"rel_attention_fwd {dtype}", lambda seed: (
            fa.rel_attention_fwd(*fwd, seed=seed, dropout_p=DROPOUT_P),))
        _seed_checks(f"rel_attention_bwd {dtype}", lambda seed:
                     fa.rel_attention_bwd(*bwd, seed=seed,
                                          dropout_p=DROPOUT_P)[:3])
        if dtype == torch.float32:
            # q and the biases at 0 make a row uniform over its i + 1 keys;
            # with v = 1 the output is kept / (i + 1) x keep-scale
            probe = fa.rel_attention_fwd(
                torch.zeros_like(q), torch.zeros_like(rwbs),
                torch.zeros_like(rrbs), k, torch.ones_like(v), w_r, fwd[6],
                fwd[7], fwd[8], torch.zeros_like(fwd[9]), scale, **drop)
            n_keys = (1 + torch.arange(t, device=dev)).double()
            kept = (probe[:, :, 0].double() / prng.keep_scale_for(DROPOUT_P)
                    * n_keys).sum()
            rate = _check_keep_rate("no-memory attention mask", float(
                kept / (n_keys.sum() * b * heads)))
            print(f"[kernel] attention mask [T, T] x {b * heads} planes: keep "
                  f"rate on the card {rate:.5f} (expected {KEEP_RATE:.5f} "
                  f"+- 0.002) [{card}]")
            del probe
        del fwd, bwd, out, s_res, lse
        torch.cuda.empty_cache()

        # ---- the projecting forward over a full ring, head at slab 2
        shape = "B=256 T=128 M=1024 D=500 L+1=7 layer=2"
        mem = randn(streams, r_blocks, b, d_model, t, dtype=dtype)
        wk3, wv3 = (randn(d_model, heads, dh, std=0.05) for _ in range(2))
        wk2, wv2 = (w.reshape(d_model, hd).to(dtype) for w in (wk3, wv3))
        psi = fa.ring_psi(fa.key_trig_basis(m_cap + t, d_model, dtype, dev), t,
                          m_cap, 256)
        tail = (k, v, w_r, fa.query_trig_table(t, m_cap, d_model, dtype, dev),
                psi, fa.build_mask_bias(t, m_cap, m_cap, 256, False,
                                        device=dev),
                (torch.arange(b, device=dev) % 50 == 7).int(), scale)
        pairs = _live(tail[5], tail[6], m_cap)[0]
        for kw, tag in (({}, ""), (drop, " dropout 0.1")):
            ours = fa.rel_attention_proj_fwd(q, rwbs, rrbs, mem, 2, wk3, wv3,
                                             *tail, save=True, **kw)
            ref = fa.rel_attention_proj_fwd_plain(
                q, rwbs, rrbs, mem, 2, wk2, wv2, *tail, save=True, **kw)
            live = ref[3] > -1e30
            if not torch.equal(live, ours[3] > -1e30):
                raise AssertionError(f"rel_attention_proj_fwd {dtype}: masks "
                                     "differ")
            err = max(_compare("proj out" + tag, ours[0], ref[0], tol),
                      _compare("proj k_mem" + tag, ours[1], ref[1], tol),
                      _compare("proj v_mem" + tag, ours[2], ref[2], tol),
                      _compare_scaled("proj S" + tag, ours[3][live],
                                      ref[3][live], tol),
                      _compare_scaled("proj lse" + tag, ours[4], ref[4], tol))
            del ref, live
            # on the tensor cores it projects with project_mem_kv's tile, in
            # its k-order: the slabs are compared bit for bit too
            k2, v2 = fa.project_mem_kv(mem, 2, wk3, wv3)
            torch.cuda.synchronize()
            print(f"[kernel] rel_attention_proj_fwd{tag} {shape} {dtype}: "
                  f"k_mem, v_mem equal project_mem_kv's bit for bit: "
                  f"{torch.equal(ours[1], k2) and torch.equal(ours[2], v2)} "
                  f"[{card}]")
            two = fa.rel_attention_mem_fwd(q, rwbs, rrbs, k2, k, v2, v,
                                           *tail[2:], save=True, **kw)
            live = two[1] > -1e30
            pair = max(_compare("proj vs two kernels k_mem" + tag, ours[1],
                                k2, tol),
                       _compare("proj vs two kernels v_mem" + tag, ours[2],
                                v2, tol),
                       _compare("proj vs two kernels out" + tag, ours[0],
                                two[0], tol),
                       _compare_scaled("proj vs two kernels S" + tag,
                                       ours[3][live], two[1][live], tol),
                       _compare_scaled("proj vs two kernels lse" + tag,
                                       ours[4], two[2], tol))
            del two, k2, v2, live

            def two_kernels():
                km, vm = fa.project_mem_kv(mem, 2, wk3, wv3)
                return fa.rel_attention_mem_fwd(q, rwbs, rrbs, km, k, vm, v,
                                                *tail[2:], save=True, **kw)
            print(f"[kernel] project_mem_kv + rel_attention_mem_fwd save=True"
                  f"{tag} {shape} {dtype}: {_cuda_ms(two_kernels, 3, 1):.4f} "
                  f"ms, the two kernels that rel_attention_proj_fwd joins "
                  f"(its outputs within {scaled} of theirs: max abs err "
                  f"{pair:.3e}) [{card}]")
            _rerun_equal(f"rel_attention_proj_fwd{tag} {dtype}",
                         lambda: fa.rel_attention_proj_fwd(
                             q, rwbs, rrbs, mem, 2, wk3, wv3, *tail,
                             save=True, **kw))
            # the projection (4 D HD a memory token) and the attention's
            # products at the tensor-core rate
            report("rel_attention_proj_fwd" if kw else None,
                   "rel_attention_proj_fwd save=True (out, k_mem, v_mem, S, "
                   "lse; two runs bit-equal)" + tag, shape, dtype, err, scaled,
                   lambda: fa.rel_attention_proj_fwd(
                       q, rwbs, rrbs, mem, 2, wk3, wv3, *tail, save=True,
                       **kw),
                   lambda: fa.rel_attention_proj_fwd_plain(
                       q, rwbs, rrbs, mem, 2, wk2, wv2, *tail, save=True,
                       **kw),
                   nbytes=_nbytes(q, rwbs, rrbs, mem[2], wk2, wv2, *tail[:-1],
                                  *ours), bound_bf16=True,
                   **_mma_fwd_ops(dtype, 4 * d_model * hd * b * m_cap
                                  + _attention_flops(b, heads, dh, t, f2,
                                                     pairs)))
            del ours
        _seed_checks(f"rel_attention_proj_fwd {dtype}", lambda seed: (
            fa.rel_attention_proj_fwd(q, rwbs, rrbs, mem, 2, wk3, wv3, *tail,
                                      seed=seed, dropout_p=DROPOUT_P)[0],))
        del tail, psi, q, k, v, dout
        torch.cuda.empty_cache()

        # ---- the stacked ring write, and one layer's write at this shape
        shape = "L+1=7 R=8 B=256 D=500 Tb=128"
        rows = randn(streams, b, d_model, t, dtype=dtype)
        buf_k, buf_p = mem.clone(), mem.clone()
        layout.ring_write(buf_k, rows, 5, 1)
        layout.ring_write_plain(buf_p, rows, 5, 1)
        torch.cuda.synchronize()
        if not torch.equal(buf_k, buf_p) or torch.equal(buf_k, mem):
            raise AssertionError(f"ring_write {dtype}: kernel and plain "
                                 "differ, or nothing was written")
        report("ring_write", "ring_write axis=1", shape, dtype, 0.0, "exact",
               lambda: layout.ring_write(buf_k, rows, 5, 1),
               lambda: layout.ring_write_plain(buf_p, rows, 5, 1), 10,
               nbytes=2 * _nbytes(rows),
               library=lambda: buf_p[:, 5].copy_(rows))
        layout.ring_write_layer(buf_k, rows[3], 3, 6)
        layout.ring_write_layer_plain(buf_p, rows[3], 3, 6)
        torch.cuda.synchronize()
        if not torch.equal(buf_k, buf_p):
            raise AssertionError(f"ring_write_layer {dtype}: kernel and "
                                 "plain differ")
        report(None, "ring_write_layer", shape, dtype, 0.0, "exact",
               lambda: layout.ring_write_layer(buf_k, rows[3], 3, 6),
               lambda: layout.ring_write_layer_plain(buf_p, rows[3], 3, 6),
               10, nbytes=2 * _nbytes(rows[3]),
               library=lambda: buf_p[3, 6].copy_(rows[3]))
        del mem, buf_k, buf_p, rows
        torch.cuda.empty_cache()

        # ---- the FFN block with the o projection inside
        shape = "B=256 T=128 D=500 F=1000 HD=500"
        w1 = randn(d_model, d_ff, std=0.05, dtype=dtype)
        w2 = randn(d_ff, d_model, std=0.05, dtype=dtype)
        wo = randn(hd, d_model, std=0.05, dtype=dtype)
        g1, be1, g2, be2 = (1.0 + randn(d_model, std=0.1),
                            randn(d_model, std=0.1),
                            1.0 + randn(d_model, std=0.1),
                            randn(d_model, std=0.1))
        vec = randn(b, hd, t, dtype=dtype)
        fwd = (randn(b, d_model, t, dtype=dtype), vec, w1,
               randn(d_ff, std=0.1), w2, randn(d_model, std=0.1), g1, be1, g2,
               be2)
        dy = randn(b, d_model, t, dtype=dtype)
        for kw, tag in (({}, ""), (drop, " dropout 0.1")):
            saved = fused_ffn.ffn_block_fwd(*fwd, save=True, wo=wo, **kw)
            err = 0.0
            for o, pl in zip(saved, fused_ffn.ffn_block_fwd_plain(
                    *fwd, save=True, wo=wo, **kw)):
                err = max(err, _compare(f"ffn_block_fused_o_fwd{tag} {dtype}",
                                        o, pl, tol))
            _rerun_equal(f"ffn_block_fused_o_fwd{tag} {dtype}",
                         lambda: fused_ffn.ffn_block_fwd(*fwd, save=True,
                                                         wo=wo, **kw))
            report("ffn_block_fused_o_fwd" if kw else None,
                   "ffn_block_fused_o_fwd save=True (y, norm1, norm2, h1, "
                   "rstd; two runs bit-equal)" + tag, shape, dtype, err,
                   f"atol=rtol={tol}",
                   lambda: fused_ffn.ffn_block_fwd(*fwd, save=True, wo=wo,
                                                   **kw),
                   lambda: fused_ffn.ffn_block_fwd_plain(*fwd, save=True,
                                                         wo=wo, **kw), 10,
                   nbytes=_nbytes(*fwd, wo, *saved), bound_bf16=True,
                   **_mma_fwd_ops(dtype, (4 * d_model * d_ff + 2 * hd * d_model)
                                  * b * t))
            # the default path it replaces: o = o_net(vec) by torch.matmul,
            # then ffn_block_fwd (#7)
            w_o = wo.t().contiguous()

            def default_fwd():
                return fused_ffn.ffn_block_fwd(fwd[0], torch.matmul(w_o, vec),
                                               *fwd[2:], save=True, **kw)
            print(f"[kernel] torch.matmul for o + ffn_block_fwd save=True{tag} "
                  f"{shape} {dtype}: {_cuda_ms(default_fwd, 10, 1):.4f} ms, "
                  f"the default path that ffn_block_fused_o_fwd replaces "
                  f"[{card}]")
            bwd = (w1, w2, g1, be1, g2, *saved[1:], dy)
            ours = fused_ffn.ffn_block_bwd(*bwd, vec=vec, wo=wo, **kw)
            err = 0.0
            for o, pl, name in zip(
                    ours, fused_ffn.ffn_block_bwd_plain(*bwd, vec=vec, wo=wo,
                                                        **kw),
                    ("dx", "dvec", "dW1", "db1", "dW2", "db2", "dg1", "dbe1",
                     "dg2", "dbe2", "dWo")):
                err = max(err, _compare_scaled(
                    f"ffn_block_fused_o_bwd {name}{tag} {dtype}", o, pl, tol))
            _rerun_equal(f"ffn_block_fused_o_bwd{tag} {dtype}",
                         lambda: fused_ffn.ffn_block_bwd(*bwd, vec=vec, wo=wo,
                                                         **kw))
            report("ffn_block_fused_o_bwd" if kw else None,
                   "ffn_block_fused_o_bwd (two runs bit-equal)" + tag, shape,
                   dtype, err, scaled,
                   lambda: fused_ffn.ffn_block_bwd(*bwd, vec=vec, wo=wo, **kw),
                   lambda: fused_ffn.ffn_block_bwd_plain(*bwd, vec=vec, wo=wo,
                                                         **kw), 10,
                   nbytes=_nbytes(*bwd, vec, wo, *ours), bound_bf16=True,
                   **_mma_fwd_ops(dtype, (8 * d_model * d_ff + 4 * hd * d_model)
                                  * b * t))
            w_leaf = w_o.detach().requires_grad_()
            v_leaf = vec.detach().requires_grad_()
            o_default = torch.matmul(w_leaf, v_leaf)

            def default_bwd():
                do = fused_ffn.ffn_block_bwd(*bwd, **kw)[1]
                return torch.autograd.grad(o_default, (v_leaf, w_leaf), do,
                                           retain_graph=True)
            print(f"[kernel] ffn_block_bwd + autograd's dvec and dWo of the "
                  f"matmul{tag} {shape} {dtype}: "
                  f"{_cuda_ms(default_bwd, 10, 1):.4f} ms, the default path "
                  f"that ffn_block_fused_o_bwd replaces [{card}]")
            del o_default, w_leaf, v_leaf
        _seed_checks(f"ffn_block_fused_o_fwd {dtype}", lambda seed: (
            fused_ffn.ffn_block_fwd(*fwd, wo=wo, seed=seed,
                                    dropout_p=DROPOUT_P),))
        _seed_checks(f"ffn_block_fused_o_bwd {dtype}", lambda seed:
                     fused_ffn.ffn_block_bwd(*bwd, vec=vec, wo=wo, seed=seed,
                                             dropout_p=DROPOUT_P)[:2])
        del fwd, bwd, saved, ours, vec, dy
        torch.cuda.empty_cache()
    return results


def check_fast_kernels(card: str, b: int = 256, t: int = 128) -> dict:
    """Phase 1e: the forms the fast numerics add, against their plain twins
    at the training shape (ModelConfig() width, B = 256, T = 128; a full ring
    of R = 8 slabs of 128, and no memory at all), f32 and bf16, at p = 0.1
    from a fixed seed with 8-bit masks: the int8 BD forward and the int8
    dphi backward of both attentions (psi under its positional dropout, so
    psi_q clips), the int8 forward at the eval shape (B = 10, M = 2048, no
    dropout), and the 8-bit form of the FFN kernels, the dropout kernel, the
    projecting forward and the fused-o FFN kernels.  An int8 form must sit
    nearer its twin than the exact scores do; its backward's dk, dv, dWk, dWv
    and d r_w_bias must equal the float form's bit for bit.  Every mask's
    keep rate is held to 1 - 26/256 +- 0.001.  The rows of the result line
    are the forms a fast-mode train step launches.  Phase 1f passes the
    chunk of a step at ``train.tgt_length=512`` (``LONG_CHUNK``: B = 64,
    T = 512): the same checks of the kernels a fast-mode step without memory
    launches there (no ring, no eval shape, no fused-o form), and no rows."""
    import torch

    from commu_tpu_torch.ops import dropout
    from commu_tpu_torch.ops import fused_attention as fa
    from commu_tpu_torch.ops import fused_ffn, prng

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(21)
    d_model, heads, d_ff = 500, 10, 1000
    dh = d_model // heads
    hd = heads * dh
    r_blocks, streams = 8, 7
    long = (b, t) == LONG_CHUNK
    scale = 1.0 / dh ** 0.5
    drop8 = dict(seed=DROPOUT_SEED, dropout_p=DROPOUT_P, bits=8)
    results = {}

    def randn(*shape, std=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    def report(name, *args, **kwargs):
        _report_kernel(results, card, None if long else name, *args,
                       **kwargs)

    def dropped_psi(k_len, m_cap, count, head, dtype):
        """psi as a train step hands it over: ring order, then the
        positional dropout (16-bit mask, kept entries over 1 - p)."""
        psi = fa.ring_psi(fa.key_trig_basis(k_len, d_model, dtype, dev),
                          k_len - m_cap, count, head)
        keep = prng.keep_mask(DROPOUT_SEED + 3, tuple(psi.shape), DROPOUT_P,
                              device=dev, bits=16)
        return torch.where(keep, psi / torch.tensor(1.0 - DROPOUT_P,
                                                    dtype=dtype), 0).to(dtype)

    def keep_rate_8(name, probe, n_keys):
        kept = (probe[:, :, 0].double()
                / prng.keep_scale_for(DROPOUT_P, bits=8) * n_keys).sum()
        rate = _check_keep_rate(name, float(
            kept / (n_keys.sum() * probe.shape[0] * heads)), KEEP_RATE_8,
            0.001)
        print(f"[kernel] {name} x {probe.shape[0] * heads} planes at 8 bits: "
              f"keep rate on the card {rate:.5f} (expected "
              f"{KEEP_RATE_8:.5f} +- 0.001) [{card}]")

    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        int8_tol = INT8_TOL.format(tol=tol, far=max(20 * tol, 5e-3))
        q, k_win, v_win, dout = (randn(b, heads, dh, t, dtype=dtype)
                                 for _ in range(4))
        w_r = fa.pack_r_kernel(randn(d_model, d_model, std=0.05),
                               heads).to(dtype)
        f2 = w_r.shape[2]
        rwbs, rrbs = fa._scaled_biases(randn(heads, dh, std=0.1),
                                       randn(heads, dh, std=0.1), scale, dtype)
        reset = (torch.arange(b, device=dev) % 50 == 7).int()

        # ---- both attentions: over a full ring (head at slab 2), then the
        # window alone
        for m_cap in (0,) if long else (r_blocks * t, 0):
            shape = f"B={b} T={t} M={m_cap} D=500, 8-bit masks p=0.1"
            k_len = m_cap + t
            psi = dropped_psi(k_len, m_cap, m_cap, 256 if m_cap else 0, dtype)
            psi_q = fa.quantize_psi_int8(psi)
            if int(psi_q.abs().max()) != 127 or float(psi.abs().max()) <= 1.0:
                raise AssertionError("psi under dropout should clip at 127")
            mode = dict(drop8, psi_q=psi_q)
            trig_a = fa.query_trig_table(t, m_cap, d_model, dtype, dev)
            mask = fa.build_mask_bias(t, m_cap, m_cap, 256 if m_cap else 0,
                                      False, device=dev)
            pairs, mem_cols = _live(mask, reset, m_cap)
            int8_ops = heads * pairs * 2 * f2  # phi_q psi_q, or ds_q psi_q^T
            if m_cap:
                mem = randn(streams, r_blocks, b, d_model, t, dtype=dtype)
                wk, wv = (randn(d_model, heads, dh, std=0.05)
                          for _ in range(2))
                k_mem, v_mem = fa.project_mem_kv(mem, 2, wk, wv)
                fwd = (q, rwbs, rrbs, k_mem, k_win, v_mem, v_win, w_r, trig_a,
                       psi, mask, reset, scale)
                fwd_k, fwd_p = (fa.rel_attention_mem_fwd,
                                fa.rel_attention_mem_fwd_plain)
                bwd_k, bwd_p = (fa.rel_attention_mem_bwd,
                                fa.rel_attention_mem_bwd_plain)
                kernel = "rel_attention_mem"
                names = ("dq", "dk_win", "dv_win", "dWk", "dWv", "dW_r",
                         "d r_w_bias", "d r_r_bias")
                exact = (1, 2, 3, 4, 6)
            else:
                fwd = (q, rwbs, rrbs, k_win, v_win, w_r, trig_a, psi, mask,
                       reset, scale)
                fwd_k, fwd_p = fa.rel_attention_fwd, fa.rel_attention_fwd_plain
                bwd_k, bwd_p = fa.rel_attention_bwd, fa.rel_attention_bwd_plain
                kernel = "rel_attention"
                names = ("dq", "dk", "dv", "dW_r", "d r_w_bias", "d r_r_bias")
                exact = (1, 2, 4)
            out, s_res, lse = fwd_k(*fwd, save=True, **mode)
            ref = fwd_p(*fwd, save=True, **mode)
            live = ref[1] > -1e30
            if not torch.equal(live, s_res > -1e30):
                raise AssertionError(f"{kernel}_fwd[int8] {dtype}: masks "
                                     "differ")
            err = max(_compare_int8(f"{kernel}_fwd[int8] out", out, ref[0],
                                    tol),
                      _compare_int8(f"{kernel}_fwd[int8] S", s_res[live],
                                    ref[1][live], tol),
                      _compare_int8(f"{kernel}_fwd[int8] lse", lse, ref[2],
                                    tol))
            # the int8 form is what ran: the kernel's scores sit nearer the
            # int8 twin's than the exact twin's do
            s_exact = fwd_p(*fwd, save=True, **drop8)[1]
            gap = float((ref[1][live] - s_exact[live]).abs().mean())
            near = float((s_res[live] - ref[1][live]).abs().mean())
            if not 0.0 <= near < 0.25 * gap:
                raise AssertionError(
                    f"{kernel}_fwd[int8] {dtype}: mean |S - twin| {near:.3e} "
                    f"against {gap:.3e} between the int8 and exact twins")
            print(f"[kernel] {kernel}_fwd[int8] {shape} {dtype}: mean |S - int8 "
                  f"twin| {near:.3e}, int8 twin to exact twin {gap:.3e} "
                  f"[{card}]")
            del s_exact, live
            operands = fwd[:-1] + (psi_q,)
            ops = _attention_fwd_ops(dtype, b, heads, dh, t, f2, pairs, True)
            report(f"{kernel}_fwd[int8]",
                   f"{kernel}_fwd[int8] save=True (out, S, lse)", shape, dtype,
                   err, int8_tol, lambda: fwd_k(*fwd, save=True, **mode),
                   lambda: fwd_p(*fwd, save=True, **mode),
                   nbytes=_nbytes(*operands, out, s_res, lse),
                   bound_bf16=True, **ops)
            if m_cap:
                bwd = (q, rwbs, rrbs, k_mem, k_win, v_mem, v_win, mem, 2, w_r,
                       trig_a, psi, ref[1], ref[2], ref[0], dout, scale)
            else:
                bwd = (q, rwbs, rrbs, k_win, v_win, w_r, trig_a, psi, ref[1],
                       ref[2], ref[0], dout, scale)
            del ref
            ours = bwd_k(*bwd, **mode)
            twin = bwd_p(*bwd, **mode)
            err = 0.0
            for o, pl, name in zip(ours, twin, names):
                err = max(err, _compare_int8(
                    f"{kernel}_bwd[int8] {name} {dtype}", o, pl, tol))
            del twin
            float_form = bwd_k(*bwd, **drop8)
            again = bwd_k(*bwd, **mode)
            torch.cuda.synchronize()
            for i in exact:
                if not torch.equal(ours[i], float_form[i]):
                    raise AssertionError(
                        f"{kernel}_bwd[int8] {dtype}: {names[i]} differs from "
                        "the float form's (only dphi is quantised)")
            if torch.equal(ours[0], float_form[0]):
                raise AssertionError(f"{kernel}_bwd[int8] {dtype}: dq equals "
                                     "the float form's")
            if not all(torch.equal(x, y) for x, y in zip(ours, again)):
                raise AssertionError(f"{kernel}_bwd[int8]: two runs differ")
            tensors = [x for x in bwd[:-1] if isinstance(x, torch.Tensor)]
            if m_cap:  # the ring is read at one layer
                tensors = [mem[2] if x is mem else x for x in tensors]
            report(f"{kernel}_bwd[int8]",
                   f"{kernel}_bwd[int8] (two runs bit-equal; dk, dv and the "
                   "content sums equal the float form's)", shape, dtype, err,
                   int8_tol, lambda: bwd_k(*bwd, **mode),
                   lambda: bwd_p(*bwd, **mode),
                   nbytes=_nbytes(*tensors, psi_q, *ours), bound_bf16=True,
                   int8_ops=int8_ops, **_tensor_core_ops(
                       dtype, _attention_bwd_flops(b, heads, dh, t, f2,
                                                   d_model, pairs, mem_cols)
                       - int8_ops))
            if PASSES:
                what = f"{shape} {str(dtype).split('.')[-1]}"
                _print_passes(f"{kernel}_bwd {what}", card,
                              lambda: bwd_k(*bwd, **drop8))
                _print_passes(f"{kernel}_bwd[int8] {what}", card,
                              lambda: bwd_k(*bwd, **mode))
                if m_cap:
                    _print_sums_yardsticks(dtype, b, heads, dh, t, m_cap, f2,
                                           d_model, pairs, mem_cols, mem)
            del ours, again, float_form, bwd, tensors
            if dtype == torch.float32:
                # q and the biases at 0: a row is uniform over its n
                # unmasked keys; with v = 1 the output is kept / n x scale
                zero_b = torch.zeros_like(rwbs)
                if m_cap:
                    probe = fwd_k(torch.zeros_like(q), zero_b, zero_b, k_mem,
                                  k_win, torch.ones_like(v_mem),
                                  torch.ones_like(v_win), w_r, trig_a, psi,
                                  mask, torch.zeros_like(reset), scale,
                                  **drop8)
                else:
                    probe = fwd_k(torch.zeros_like(q), zero_b, zero_b, k_win,
                                  torch.ones_like(v_win), w_r, trig_a, psi,
                                  mask, torch.zeros_like(reset), scale,
                                  **drop8)
                keep_rate_8(f"attention mask [T, {k_len}]", probe,
                            (m_cap + 1 + torch.arange(t, device=dev)).double())
                del probe
            if m_cap:
                # the projecting forward has no int8 form; its 8-bit masks
                ours = fa.rel_attention_proj_fwd(
                    q, rwbs, rrbs, mem, 2, wk, wv, *fwd[4:5], *fwd[6:],
                    save=True, **drop8)
                two = fa.rel_attention_mem_fwd(*fwd, save=True, **drop8)
                # over project_mem_kv's slabs, which its FMA projection
                # matches to the tolerance: the same masks, close values
                live = two[1] > -1e30
                if not torch.equal(live, ours[3] > -1e30):
                    raise AssertionError(
                        f"rel_attention_proj_fwd at 8 bits {dtype}: masks "
                        "differ from rel_attention_mem_fwd at 8 bits")
                pair = max(
                    _compare("proj vs rel_attention_mem_fwd at 8 bits",
                             ours[0], two[0], tol),
                    _compare_scaled("proj vs rel_attention_mem_fwd S at 8 "
                                    "bits", ours[3][live], two[1][live], tol),
                    _compare_scaled("proj vs rel_attention_mem_fwd lse at 8 "
                                    "bits", ours[4], two[2], tol))
                err = _compare("rel_attention_proj_fwd at 8 bits", ours[0],
                               fa.rel_attention_mem_fwd_plain(
                                   *fwd, **drop8), tol)
                print(f"[kernel] rel_attention_proj_fwd[bits8] {shape} {dtype}:"
                      f" within {tol} x max|ref| of rel_attention_mem_fwd"
                      f"[bits8] (max abs err {pair:.3e}); "
                      f"max_abs_err={err:.3e} against the twin (atol=rtol="
                      f"{tol}) [{card}]")
                del live
                del ours, two, mem, k_mem, v_mem
            del fwd, out, s_res, lse, psi, psi_q, mode
            torch.cuda.empty_cache()
        del q, k_win, v_win, dout

        # ---- the int8 forward at the eval shape: a full ring of 16 slabs,
        # no dropout (eval windows inside a training process run it)
        if not long:  # the eval shape has no window of 512
            eb, er = 10, 16
            em = er * t
            shape = f"B=10 T=128 M={em} count={em} head=640"
            q, k_win, v_win = (randn(eb, heads, dh, t, dtype=dtype)
                               for _ in range(3))
            k_mem, v_mem = (randn(eb, er, heads, dh, t, dtype=dtype)
                            for _ in range(2))
            psi = fa.ring_psi(fa.key_trig_basis(em + t, d_model, dtype, dev),
                              t, em, 640)
            psi_q = fa.quantize_psi_int8(psi)
            mask = fa.build_mask_bias(t, em, em, 640, True, device=dev)
            ereset = (torch.arange(eb, device=dev) == 3).int()
            fwd = (q, rwbs, rrbs, k_mem, k_win, v_mem, v_win, w_r,
                   fa.query_trig_table(t, em, d_model, dtype, dev), psi, mask,
                   ereset, scale)
            pairs = _live(mask, ereset)[0]
            err = _compare_int8(
                f"rel_attention_mem_fwd[int8] eval {dtype}",
                fa.rel_attention_mem_fwd(*fwd, psi_q=psi_q),
                fa.rel_attention_mem_fwd_plain(*fwd, psi_q=psi_q), tol)
            report(None, "rel_attention_mem_fwd[int8]", shape, dtype, err,
                   int8_tol,
                   lambda: fa.rel_attention_mem_fwd(*fwd, psi_q=psi_q),
                   lambda: fa.rel_attention_mem_fwd_plain(*fwd, psi_q=psi_q),
                   10, nbytes=_nbytes(*fwd[:-1], psi_q, q), bound_bf16=True,
                   **_attention_fwd_ops(dtype, eb, heads, dh, t, f2, pairs,
                                        True))
            del q, k_win, v_win, k_mem, v_mem, psi, psi_q, mask, fwd
            torch.cuda.empty_cache()

        # ---- the FFN block at 8 bits, plain and with the o projection inside
        shape = f"B={b} T={t} D=500 F=1000, 8-bit masks p=0.1"
        w1 = randn(d_model, d_ff, std=0.05, dtype=dtype)
        w2 = randn(d_ff, d_model, std=0.05, dtype=dtype)
        wo = randn(hd, d_model, std=0.05, dtype=dtype)
        g1, be1, g2, be2 = (1.0 + randn(d_model, std=0.1),
                            randn(d_model, std=0.1),
                            1.0 + randn(d_model, std=0.1),
                            randn(d_model, std=0.1))
        fwd = (randn(b, d_model, t, dtype=dtype),
               randn(b, d_model, t, dtype=dtype), w1, randn(d_ff, std=0.1),
               w2, randn(d_model, std=0.1), g1, be1, g2, be2)
        dy = randn(b, d_model, t, dtype=dtype)
        for fuse in (False,) if long else (False, True):
            kw = dict(drop8, wo=wo) if fuse else drop8
            what = "ffn_block_fused_o" if fuse else "ffn_block"
            saved = fused_ffn.ffn_block_fwd(*fwd, save=True, **kw)
            err = 0.0
            for o, pl in zip(saved, fused_ffn.ffn_block_fwd_plain(
                    *fwd, save=True, **kw)):
                err = max(err, _compare(f"{what}_fwd[bits8] {dtype}", o, pl,
                                        tol))
            # the plain form's products run on the tensor cores, the wo
            # form's on FMA loops
            report(None if fuse else "ffn_block_fwd[bits8]",
                   f"{what}_fwd[bits8] save=True (y, norm1, norm2, h1, rstd)",
                   shape, dtype, err, f"atol=rtol={tol}",
                   lambda: fused_ffn.ffn_block_fwd(*fwd, save=True, **kw),
                   lambda: fused_ffn.ffn_block_fwd_plain(*fwd, save=True,
                                                         **kw), 10,
                   nbytes=0 if fuse else _nbytes(*fwd, *saved),
                   bound_bf16=not fuse,
                   **({"flops": 4 * d_model * d_ff * b * t} if fuse else
                      _mma_fwd_ops(dtype, 4 * d_model * d_ff * b * t)))
            bwd = (w1, w2, g1, be1, g2, *saved[1:], dy)
            bkw = dict(drop8, vec=fwd[1], wo=wo) if fuse else drop8
            ours = fused_ffn.ffn_block_bwd(*bwd, **bkw)
            err = 0.0
            for o, pl in zip(ours, fused_ffn.ffn_block_bwd_plain(*bwd, **bkw)):
                err = max(err, _compare_scaled(f"{what}_bwd[bits8] {dtype}",
                                               o, pl, tol))
            # the plain form's products run on the tensor cores, the wo
            # form's on FMA loops
            report(None if fuse else "ffn_block_bwd[bits8]",
                   f"{what}_bwd[bits8]", shape, dtype, err,
                   f"{tol} x max|ref| per output",
                   lambda: fused_ffn.ffn_block_bwd(*bwd, **bkw),
                   lambda: fused_ffn.ffn_block_bwd_plain(*bwd, **bkw), 10,
                   nbytes=0 if fuse else _nbytes(*bwd, *ours),
                   bound_bf16=not fuse,
                   **({"flops": 8 * d_model * d_ff * b * t} if fuse else
                      _tensor_core_ops(dtype, 8 * d_model * d_ff * b * t)))
            if PASSES and not fuse:
                _print_passes(f"ffn_block_bwd[bits8] {shape} "
                              f"{str(dtype).split('.')[-1]}", card,
                              lambda: fused_ffn.ffn_block_bwd(*bwd, **bkw))
            del saved, ours, bwd
        # the three masks bit for bit, as in the 16-bit phase
        one, zero = torch.ones(d_model, device=dev), torch.zeros(d_model,
                                                                 device=dev)
        probe = fused_ffn.ffn_block_fwd(
            torch.zeros_like(fwd[0]), torch.ones_like(fwd[0]),
            torch.zeros_like(w1), torch.ones(d_ff, device=dev),
            torch.zeros_like(w2), 1000.0 * one, one, zero, one, zero,
            save=True, **drop8)
        for salt, rows, got in ((fused_ffn.SALT_O, d_model, probe[1] > 0),
                                (fused_ffn.SALT_H, d_ff, probe[3] > 0),
                                (fused_ffn.SALT_F, d_model, probe[2] > 0)):
            want = prng.keep_mask(prng.row_seeds(DROPOUT_SEED, b, 8192,
                                                 salt * 2048, device=dev),
                                  (rows, t), DROPOUT_P, bits=8)
            if not torch.equal(got, want):
                raise AssertionError(f"ffn_block_fwd[bits8] {dtype}: mask of "
                                     f"salt {salt} differs from keep_mask")
            rate = _check_keep_rate(f"FFN mask salt {salt} at 8 bits",
                                    float(got.double().mean()), KEEP_RATE_8,
                                    0.001)
            print(f"[kernel] ffn_block_fwd[bits8] {dtype} mask salt {salt} "
                  f"[{rows}, {t}] x {b}: equals keep_mask bit for bit, keep "
                  f"rate on the card {rate:.5f} (expected {KEEP_RATE_8:.5f} "
                  f"+- 0.001) [{card}]")
        del probe

        # ---- the activation dropout at 8 bits
        x = fwd[0]
        for salt in (dropout.SALT_EMB, dropout.SALT_OUT):
            leaf = x.clone().requires_grad_(True)
            y = dropout.dropout_bdt(leaf, DROPOUT_SEED, DROPOUT_P, salt,
                                    bits=8)
            y.backward(dy)
            torch.cuda.synchronize()
            if not (torch.equal(y.detach(), dropout.dropout_bdt_plain(
                        x, DROPOUT_SEED, DROPOUT_P, salt, 8))
                    and torch.equal(leaf.grad, dropout.dropout_bdt_plain(
                        dy, DROPOUT_SEED, DROPOUT_P, salt, 8))):
                raise AssertionError(f"dropout_bdt[bits8] salt {salt} {dtype}:"
                                     " kernel and plain differ")
            rate = _check_keep_rate(f"dropout_bdt[bits8] salt {salt}", float(
                (dropout.dropout_bdt_apply(torch.ones_like(x), DROPOUT_SEED,
                                           DROPOUT_P, salt, 8) != 0)
                .double().mean()), KEEP_RATE_8, 0.001)
            print(f"[kernel] dropout_bdt[bits8] salt {salt} {dtype}: forward "
                  f"and backward equal the plain twin exactly, keep rate on "
                  f"the card {rate:.5f} (expected {KEEP_RATE_8:.5f} +- 0.001) "
                  f"[{card}]")
        report("dropout_bdt[bits8]", "dropout_bdt[bits8] p=0.1",
               f"B={b} D=500 T={t}", dtype, 0.0, "exact",
               lambda: dropout.dropout_bdt_apply(x, DROPOUT_SEED, DROPOUT_P,
                                                 dropout.SALT_EMB, 8),
               lambda: dropout.dropout_bdt_plain(x, DROPOUT_SEED, DROPOUT_P,
                                                 dropout.SALT_EMB, 8), 10,
               nbytes=2 * _nbytes(x), flops=14 * x.numel(),
               library=lambda: torch.nn.functional.dropout(x, DROPOUT_P,
                                                           training=True))
        del fwd, leaf, y, x, dy
        torch.cuda.empty_cache()
    return results


def time_forward_forms(card: str) -> None:
    """``--passes``: the forms of the two forwards a training step launches,
    timed apart at the training shape (B = 256, T = 128, M = 1024,
    ModelConfig() width), f32 and bf16: ``rel_attention_mem_fwd`` in its
    float and int8 BD forms, with and without the residual (S, lse), at p =
    0 and at p = 0.1 with 8-bit masks (what the S write and the mask hash
    cost), and at the eval shape (B = 10, M = 2048); ``ffn_block_fwd`` at
    the serving (G = 8, T = 11), eval (B = 10) and training shapes, with the
    save outputs and the 8-bit masks at the training shape, and one launch
    of its ``[bits8]`` form split into its CUDA kernels (``[forms]`` and
    ``[passes]`` lines).  Run from a checkout of another commit, it times
    that commit's kernels the same way."""
    import torch

    from commu_tpu_torch.ops import fused_attention as fa
    from commu_tpu_torch.ops import fused_ffn

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(31)
    d_model, heads, d_ff = 500, 10, 1000
    dh = d_model // heads
    b, t, r_blocks = 256, 128, 8
    m_cap = r_blocks * t
    scale = 1.0 / dh ** 0.5
    drop8 = dict(seed=DROPOUT_SEED, dropout_p=DROPOUT_P, bits=8)

    def randn(*shape, std=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        # the training shape, then the eval shape (B = 10, a full ring of 16
        # slabs, no dropout, no residual)
        for bb, rr, forms in ((b, r_blocks, ((False, {}), (False, drop8),
                                             (True, {}), (True, drop8))),
                              (10, 16, ((False, {}),))):
            mm = rr * t
            q, k_win, v_win = (randn(bb, heads, dh, t, dtype=dtype)
                               for _ in range(3))
            k_mem, v_mem = (randn(bb, rr, heads, dh, t, dtype=dtype)
                            for _ in range(2))
            w_r = fa.pack_r_kernel(randn(d_model, d_model, std=0.05),
                                   heads).to(dtype)
            rwbs, rrbs = fa._scaled_biases(randn(heads, dh, std=0.1),
                                           randn(heads, dh, std=0.1), scale,
                                           dtype)
            psi = fa.ring_psi(fa.key_trig_basis(mm + t, d_model, dtype, dev),
                              t, mm, 256)
            fwd = (q, rwbs, rrbs, k_mem, k_win, v_mem, v_win, w_r,
                   fa.query_trig_table(t, mm, d_model, dtype, dev), psi,
                   fa.build_mask_bias(t, mm, mm, 256, bb == 10, device=dev),
                   (torch.arange(bb, device=dev) % 50 == 7).int(), scale)
            psi_q = fa.quantize_psi_int8(psi)
            for form, extra in (("float", {}), ("int8", {"psi_q": psi_q})):
                for save, kw in forms:
                    ms = _cuda_ms(lambda: fa.rel_attention_mem_fwd(
                        *fwd, save=save, **kw, **extra), 5, 1)
                    tag = "p=0.1 8-bit" if kw else "p=0"
                    print(f"[forms] rel_attention_mem_fwd {form} BD, "
                          f"save={save}, {tag}, B={bb} T={t} M={mm} {name}: "
                          f"{ms:.4f} ms [{card}]")
            del q, k_win, v_win, k_mem, v_mem, fwd, psi, psi_q
            torch.cuda.empty_cache()

        # the window alone (#1): the training shape without memory, with and
        # without the residual and the 8-bit masks; the serving prefill (T =
        # 11) and other short windows
        for bb, tt, forms in ((b, t, ((False, {}), (True, {}),
                                      (True, drop8))),
                              *((8, tt, ((False, {}),))
                                for tt in (11, 16, 32, 64))):
            q, k, v = (randn(bb, heads, dh, tt, dtype=dtype)
                       for _ in range(3))
            w_r = fa.pack_r_kernel(randn(d_model, d_model, std=0.05),
                                   heads).to(dtype)
            rwbs, rrbs = fa._scaled_biases(randn(heads, dh, std=0.1),
                                           randn(heads, dh, std=0.1), scale,
                                           dtype)
            psi = fa.key_trig_basis(tt, d_model, dtype, dev)
            fwd = (q, rwbs, rrbs, k, v, w_r,
                   fa.query_trig_table(tt, 0, d_model, dtype, dev), psi,
                   fa.build_mask_bias(tt, 0, 0, 0, False, device=dev),
                   (torch.arange(bb, device=dev) % 50 == 7).int(), scale)
            psi_q = fa.quantize_psi_int8(psi)
            for form, extra in (("float", {}), ("int8", {"psi_q": psi_q})):
                for save, kw in forms:
                    ms = _cuda_ms(lambda: fa.rel_attention_fwd(
                        *fwd, save=save, **kw, **extra), 10, 2)
                    tag = "p=0.1 8-bit" if kw else "p=0"
                    print(f"[forms] rel_attention_fwd {form} BD, "
                          f"save={save}, {tag}, B={bb} T={tt} M=0 {name}: "
                          f"{ms:.4f} ms [{card}]")
            del q, k, v, fwd, psi, psi_q
            torch.cuda.empty_cache()

        for g, tt, save, kw in ((8, 11, False, {}), (10, 128, False, {}),
                                (256, 128, True, {}), (256, 128, True, drop8)):
            args = (randn(g, d_model, tt, dtype=dtype),
                    randn(g, d_model, tt, dtype=dtype),
                    randn(d_model, d_ff, std=0.05, dtype=dtype),
                    randn(d_ff, std=0.1),
                    randn(d_ff, d_model, std=0.05, dtype=dtype),
                    randn(d_model, std=0.1), 1.0 + randn(d_model, std=0.1),
                    randn(d_model, std=0.1), 1.0 + randn(d_model, std=0.1),
                    randn(d_model, std=0.1))
            ms = _cuda_ms(lambda: fused_ffn.ffn_block_fwd(
                *args, save=save, **kw), 20, 3)
            what = (f"ffn_block_fwd{'[bits8]' if kw else ''} B={g} T={tt} "
                    f"save={save}")
            print(f"[forms] {what} {name}: {ms:.4f} ms [{card}]")
            if kw:
                _print_passes(f"{what} {name}", card,
                              lambda: fused_ffn.ffn_block_fwd(
                                  *args, save=save, **kw))
        torch.cuda.empty_cache()


def time_probe_forms(card: str) -> None:
    """``--passes``: the kernels of the two fused probes timed apart, each
    beside what it replaces in the same call (``[forms]`` lines), f32 and
    bf16.  The projecting forward #6 with the residual at the training
    shape (B = 256, T = 128, M = 1024: p = 0, p = 0.1 at 16 and 8 bits) and
    without it at the eval shape (B = 10, M = 2048), against
    ``project_mem_kv`` + ``rel_attention_mem_fwd`` on the same inputs; the
    FFN block with the o projection inside (#9) at the training shape (HD =
    500, p = 0 and 0.1), its forward against o = ``torch.matmul`` then
    ``ffn_block_fwd`` (#7), its backward against ``ffn_block_bwd`` (#8) and
    autograd's two products of that matmul (dvec and dWo): the default path
    that the probe replaces.  One launch of each #9 form is split into its
    CUDA kernels (``[passes]``).  Run from a checkout of another commit, it
    times that commit's kernels the same way."""
    import torch

    from commu_tpu_torch.ops import fused_attention as fa
    from commu_tpu_torch.ops import fused_ffn

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(37)
    d_model, heads, d_ff, t = 500, 10, 1000, 128
    dh = d_model // heads
    hd = heads * dh
    scale = 1.0 / dh ** 0.5
    drop = dict(seed=DROPOUT_SEED, dropout_p=DROPOUT_P, bits=16)
    drop8 = dict(drop, bits=8)

    def randn(*shape, std=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for b, r_blocks, save, forms in (
                (256, 8, True, (("p=0", {}), ("p=0.1", drop),
                                ("p=0.1 8-bit", drop8))),
                (10, 16, False, (("p=0", {}),))):
            m_cap = r_blocks * t
            q, k, v = (randn(b, heads, dh, t, dtype=dtype) for _ in range(3))
            mem = randn(3, r_blocks, b, d_model, t, dtype=dtype)
            wk3, wv3 = (randn(d_model, heads, dh, std=0.05)
                        for _ in range(2))
            w_r = fa.pack_r_kernel(randn(d_model, d_model, std=0.05),
                                   heads).to(dtype)
            rwbs, rrbs = fa._scaled_biases(randn(heads, dh, std=0.1),
                                           randn(heads, dh, std=0.1), scale,
                                           dtype)
            psi = fa.ring_psi(fa.key_trig_basis(m_cap + t, d_model, dtype,
                                                dev), t, m_cap, 256)
            tail = (w_r, fa.query_trig_table(t, m_cap, d_model, dtype, dev),
                    psi, fa.build_mask_bias(t, m_cap, m_cap, 256, b == 10,
                                            device=dev),
                    (torch.arange(b, device=dev) % 50 == 7).int(), scale)
            shape = f"B={b} T={t} M={m_cap} {name}"
            for tag, kw in forms:
                ms = _cuda_ms(lambda: fa.rel_attention_proj_fwd(
                    q, rwbs, rrbs, mem, 2, wk3, wv3, k, v, *tail, save=save,
                    **kw), 5, 1)

                def two_kernels():
                    km, vm = fa.project_mem_kv(mem, 2, wk3, wv3)
                    return fa.rel_attention_mem_fwd(
                        q, rwbs, rrbs, km, k, vm, v, *tail, save=save, **kw)
                two = _cuda_ms(two_kernels, 5, 1)
                print(f"[forms] rel_attention_proj_fwd save={save}, {tag}, "
                      f"{shape}: {ms:.4f} ms; project_mem_kv + "
                      f"rel_attention_mem_fwd {two:.4f} ms [{card}]")
            del q, k, v, mem, psi, tail
            torch.cuda.empty_cache()

        b = 256
        shape = f"B={b} T={t} D={d_model} F={d_ff} HD={hd} {name}"
        w_o = randn(d_model, hd, std=0.05, dtype=dtype)  # o_net's [D, HD]
        wo = w_o.t().contiguous()
        w1 = randn(d_model, d_ff, std=0.05, dtype=dtype)
        w2 = randn(d_ff, d_model, std=0.05, dtype=dtype)
        params = (randn(d_ff, std=0.1), randn(d_model, std=0.1),
                  1.0 + randn(d_model, std=0.1), randn(d_model, std=0.1),
                  1.0 + randn(d_model, std=0.1), randn(d_model, std=0.1))
        b1, b2, g1, be1, g2, be2 = params
        x, vec = randn(b, d_model, t, dtype=dtype), randn(b, hd, t,
                                                          dtype=dtype)
        dy = randn(b, d_model, t, dtype=dtype)
        for tag, kw in (("p=0", {}), ("p=0.1", drop)):
            fwd = (x, vec, w1, b1, w2, b2, g1, be1, g2, be2)
            ms = _cuda_ms(lambda: fused_ffn.ffn_block_fwd(
                *fwd, save=True, wo=wo, **kw), 10, 2)
            base = _cuda_ms(lambda: fused_ffn.ffn_block_fwd(
                x, torch.matmul(w_o, vec), w1, b1, w2, b2, g1, be1, g2, be2,
                save=True, **kw), 10, 2)
            print(f"[forms] ffn_block_fused_o_fwd save=True, {tag}, {shape}: "
                  f"{ms:.4f} ms; torch.matmul for o + ffn_block_fwd "
                  f"{base:.4f} ms [{card}]")
            saved = fused_ffn.ffn_block_fwd(*fwd, save=True, wo=wo, **kw)
            bwd = (w1, w2, g1, be1, g2, *saved[1:], dy)
            ms_b = _cuda_ms(lambda: fused_ffn.ffn_block_bwd(
                *bwd, vec=vec, wo=wo, **kw), 10, 2)
            w_leaf = w_o.detach().requires_grad_()
            v_leaf = vec.detach().requires_grad_()
            o = torch.matmul(w_leaf, v_leaf)

            def default_bwd():
                dx, do = fused_ffn.ffn_block_bwd(*bwd, **kw)[:2]
                return torch.autograd.grad(o, (v_leaf, w_leaf), do,
                                           retain_graph=True)
            base_b = _cuda_ms(default_bwd, 10, 2)
            print(f"[forms] ffn_block_fused_o_bwd, {tag}, {shape}: "
                  f"{ms_b:.4f} ms; ffn_block_bwd + autograd's dvec and dWo "
                  f"of the matmul {base_b:.4f} ms [{card}]")
            if kw:
                _print_passes(f"ffn_block_fused_o_fwd save=True {tag} {shape}",
                              card, lambda: fused_ffn.ffn_block_fwd(
                                  *fwd, save=True, wo=wo, **kw))
                _print_passes(f"ffn_block_fused_o_bwd {tag} {shape}", card,
                              lambda: fused_ffn.ffn_block_bwd(
                                  *bwd, vec=vec, wo=wo, **kw))
            del saved, bwd, o, w_leaf, v_leaf
        del x, vec, dy, w1, w2, wo, w_o
        torch.cuda.empty_cache()


def time_nll_passes(card: str) -> None:
    """``--passes``: one launch of ``nll_fwd`` with the save output and one
    of ``nll_bwd`` at the training shape (B = 256, T = 128, D = 500, V =
    729), f32 and bf16, split into their CUDA kernels (``[passes]`` lines:
    the backward's operand copies, the logits recomputed into dlogits, dh,
    demb's two launches and dbias)."""
    import torch

    from commu_tpu_torch.ops import fused_nll

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    b, t, d_model, vocab = 256, 128, 500, 729
    shape = f"B={b} T={t} D={d_model} V={vocab}"
    for dtype in (torch.float32, torch.bfloat16):
        hidden = torch.randn(b, d_model, t, generator=gen,
                             device=dev).to(dtype)
        emb = torch.randn(vocab, d_model, generator=gen, device=dev) * 0.05
        bias = torch.randn(vocab, generator=gen, device=dev) * 0.1
        targets = torch.randint(1, vocab, (b, t), generator=gen, device=dev,
                                dtype=torch.int32)
        nll, lse = fused_nll.nll_fwd(hidden, emb, bias, targets, save=True)
        dnll = torch.randn(b, t, generator=gen, device=dev)
        name = str(dtype).split(".")[-1]
        _print_passes(f"nll_fwd save=True {shape} {name}", card,
                      lambda: fused_nll.nll_fwd(hidden, emb, bias, targets,
                                                save=True))
        _print_passes(f"nll_bwd {shape} {name}", card,
                      lambda: fused_nll.nll_bwd(hidden, emb, bias, targets,
                                                lse, dnll))
        del hidden, nll, lse
    torch.cuda.empty_cache()


def time_small_kernels(card: str, kernels: dict) -> None:
    """The small kernels against their library calls by device time: #13
    (``dropout_bdt``, 16- and 8-bit draws, float32 and bfloat16) against
    ``F.dropout`` (a Philox mask, not the same function), #14 (``ring_write_layer``) against the
    slab ``copy_`` at the eval and the training shape, #15
    (``cache_append``) against two slab ``copy_`` calls, at the shapes of
    their rows, and #1 (``rel_attention_fwd``) at the serving prefill (G =
    8, T = 11) and at T = 32, float32 and bfloat16, which no library call
    computes (a tree from before its tensor-core body times its FMA
    body).  Each is a CUDA graph of 100 calls, the graphs replayed in
    turns over 9 rounds; prints the median and the spread, and puts the
    medians into the rows' ``ms`` and ``library_ms`` (``timing`` says
    so)."""
    import torch

    from commu_tpu_torch.ops import dropout, layout
    from commu_tpu_torch.ops import fused_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    x = randn(256, 500, 128)
    ring_eval, rows_eval = randn(7, 16, 10, 500, 128), randn(10, 500, 128)
    ring_train, rows_train = randn(7, 8, 256, 500, 128), randn(256, 500, 128)
    cache_k, cache_v = randn(6, 8, 10, 50, 4096), randn(6, 8, 10, 50, 4096)
    k_self, v_self = randn(6, 8, 10, 50), randn(6, 8, 10, 50)
    length = torch.tensor([0, 127, 128, 500, 4095, 4096, 4095, 3],
                          dtype=torch.int32, device=dev)
    advance = torch.tensor([1, 1, 0, 1, 1, 1, 0, 1], dtype=torch.bool,
                           device=dev)

    def slab_copy():
        cache_k[..., 77].copy_(k_self)
        cache_v[..., 77].copy_(v_self)

    philox = "F.dropout (Philox mask, not the same function)"
    cases = {}
    for xx in (x, x.bfloat16()):
        name = str(xx.dtype).split(".")[-1]
        tag = "" if xx.dtype == torch.float32 else f" {name}"
        library = (lambda xx=xx: torch.nn.functional.dropout(
            xx, DROPOUT_P, training=True))
        for bits, form in ((16, "dropout_bdt"), (8, "dropout_bdt[bits8]")):
            cases[form + tag] = (
                f"B=256 D=500 T=128 p=0.1, {bits}-bit masks {name}",
                lambda xx=xx, bits=bits: dropout.dropout_bdt_apply(
                    xx, DROPOUT_SEED, DROPOUT_P, dropout.SALT_EMB, bits),
                library, philox)
    # #1 at the serving prefill (T = 11, its keys by plain loads) and at T =
    # 32 (by cp.async): no library call computes it
    gen_w = torch.Generator(device=dev).manual_seed(14)
    for dtype, t in ((torch.float32, 11), (torch.bfloat16, 11),
                     (torch.float32, 32), (torch.bfloat16, 32)):
        name = str(dtype).split(".")[-1]
        g, heads, dh, d_model = 8, 10, 50, 500
        q, k, v = (torch.randn(g, heads, dh, t, generator=gen_w, device=dev)
                   .to(dtype) for _ in range(3))
        w_r = fa.pack_r_kernel(torch.randn(d_model, d_model, generator=gen_w,
                                           device=dev) * 0.05, heads).to(dtype)
        rwbs, rrbs = fa._scaled_biases(
            torch.randn(heads, dh, generator=gen_w, device=dev) * 0.1,
            torch.randn(heads, dh, generator=gen_w, device=dev) * 0.1,
            dh ** -0.5, dtype)
        serve_args = (q, rwbs, rrbs, k, v, w_r,
                      fa.query_trig_table(t, 0, d_model, dtype, dev),
                      fa.key_trig_basis(t, d_model, dtype, dev),
                      fa.build_mask_bias(t, 0, 0, 0, False, device=dev),
                      (torch.arange(g, device=dev) % 3 == 1).int(),
                      dh ** -0.5)
        tag = "" if (dtype, t) == (torch.float32, 11) else f" T={t} {name}"
        cases["rel_attention_fwd" + tag] = (
            f"G=8 T={t} M=0 {name}",
            lambda a=serve_args: fa.rel_attention_fwd(*a), None, None)
    cases.update({
        "ring_write_layer": (
            "L+1=7 R=16 B=10 D=500 Tb=128 float32",
            lambda: layout.ring_write_layer(ring_eval, rows_eval, 5, 11),
            lambda: ring_eval[5, 11].copy_(rows_eval), "slab copy_"),
        "ring_write_layer (train shape)": (
            "L+1=7 R=8 B=256 D=500 Tb=128 float32",
            lambda: layout.ring_write_layer(ring_train, rows_train, 3, 6),
            lambda: ring_train[3, 6].copy_(rows_train), "slab copy_"),
        "cache_append": (
            "L=6 G=8 M=4096 float32",
            lambda: layout.cache_append(cache_k, cache_v, k_self, v_self,
                                        length, advance),
            slab_copy, "two slab copy_"),
    })
    fns = {}
    for name, (_, kernel, library, _) in cases.items():
        fns[(name, "kernel")] = kernel
        if library is not None:
            fns[(name, "library")] = library
    got = _interleaved_graph_ms(fns)
    for name, (shape, _, _, lib_name) in cases.items():
        k_med, k_lo, k_hi = got[(name, "kernel")]
        if lib_name is None:
            print(f"[graph] {name} {shape}: kernel median {k_med:.5f} ms "
                  f"(spread {k_lo:.5f}-{k_hi:.5f}; CUDA graph of 100 calls, "
                  f"9 rounds in turns) [{card}]")
            if name in kernels:
                kernels[name].update(
                    ms=k_med, ms_spread=[k_lo, k_hi],
                    timing="device ms per call, median of 9 rounds of a CUDA "
                           "graph of 100 calls")
            continue
        l_med, l_lo, l_hi = got[(name, "library")]
        verdict = "slower" if k_med > l_med else "faster"
        print(f"[graph] {name} {shape}: kernel median {k_med:.5f} "
              f"ms (spread {k_lo:.5f}-{k_hi:.5f}), {lib_name} median "
              f"{l_med:.5f} ms (spread {l_lo:.5f}-{l_hi:.5f}): the kernel is "
              f"{verdict} on device time (CUDA graph of 100 calls, 9 rounds "
              f"in turns) [{card}]")
        if name in kernels:
            kernels[name].update(
                ms=k_med, library_ms=l_med, ms_spread=[k_lo, k_hi],
                library_ms_spread=[l_lo, l_hi],
                timing="device ms per call, median of 9 rounds of a CUDA "
                       "graph of 100 calls, interleaved with the library's")
    del x, ring_eval, ring_train, cache_k, cache_v
    torch.cuda.empty_cache()


def check_ring_write(card: str) -> dict:
    """The stacked ring write's own path, the counterpart of the reference's
    on-chip check (``scripts/verify_tpu.py``, "ring_write aliasing kernel"):
    every slab index of a ring of the training shape (L + 1 = 7 streams,
    R = 8 slabs, B = 256, D = 500, Tb = 128), f32 and bf16, against the slab
    ``copy_``; slabs written earlier must stay as they were written.
    Returns the launches per kernel."""
    import torch

    from commu_tpu_torch.ops import _build, layout

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(16)
    streams, r_blocks, b, d_model, t = 7, 8, 256, 500, 128
    _build.reset_launches()
    for dtype in (torch.float32, torch.bfloat16):
        buf = torch.randn((streams, r_blocks, b, d_model, t), generator=gen,
                          device=dev).to(dtype)
        want = buf.clone()
        for block in range(r_blocks):
            rows = torch.randn((streams, b, d_model, t), generator=gen,
                               device=dev).to(dtype)
            want[:, block].copy_(rows)
            if layout.ring_write(buf, rows, block, 1) is not buf:
                raise AssertionError("ring_write returned another buffer")
            torch.cuda.synchronize()
            if not torch.equal(buf, want):
                raise AssertionError(f"ring_write {dtype}: slab {block} "
                                     "differs from the slab copy_")
        del buf, want, rows
        torch.cuda.empty_cache()
    launches = dict(_build.LAUNCHES)
    if launches["ring_write"] != 2 * r_blocks:
        raise AssertionError(f"ring_write launched {launches['ring_write']} "
                             f"times, expected {2 * r_blocks}")
    print(f"[ring] ring_write L+1=7 R=8 B=256 D=500 Tb=128, every slab index, "
          f"f32 and bf16: equal to the slab copy_ bit for bit, "
          f"{launches['ring_write']} launches [{card}]")
    return launches


def time_steps(card: str) -> None:
    """``--steps``: the eval window and the train steps of ``main``'s
    phases 5, 7, 8 and 9 (the two probe runs), over the same seeded corpora,
    with more fast-mode steps; nothing else runs.  The eval runs twice: the first pass of a
    fresh process also pays its one-time costs (cuBLAS, module loads, the
    allocator's growth), so the second is the window's time."""
    import numpy as np

    with tempfile.TemporaryDirectory() as tmp:
        write_corpus(Path(tmp) / "val", EVAL_LENGTHS, seed=3)
        for _ in range(2):
            evaluate(Path(tmp) / "val", card)
        rng = np.random.RandomState(6)
        write_corpus(Path(tmp) / "train", [400 + 80 * i for i in range(10)],
                     seed=7, train_lengths=rng.randint(300, 3001, size=600))
        train(Path(tmp) / "train", Path(tmp) / "runs_fast", card, True,
              ("bfloat16", "float32"), 16, (), FAST_TRAIN_KERNELS,
              FAST_UNWANTED, None, {"rel_attention_mem_bwd[int8]": 6,
                                    "ffn_block_bwd[bits8]": 6}, False)
        train(Path(tmp) / "train", Path(tmp) / "runs_fast_m0", card, True,
              ("bfloat16", "float32"), 16, NO_MEMORY, FAST_CAPACITY0_KERNELS,
              FAST_UNWANTED + MEMORY_KERNELS + (
                  "rel_attention_mem_fwd[int8]",
                  "rel_attention_mem_bwd[int8]"),
              None, {"rel_attention_bwd[int8]": 6, "ffn_block_bwd[bits8]": 6},
              False)
        _, precise_nll = train(Path(tmp) / "train", Path(tmp) / "runs", card,
                               True, ("bfloat16", "float32"), PRECISE_STEPS)
        probes(Path(tmp) / "train", Path(tmp) / "runs_probe", card,
               precise_nll["float32"])
        train(Path(tmp) / "train", Path(tmp) / "runs_m0", card, True,
              ("bfloat16", "float32"), PRECISE_STEPS, NO_MEMORY,
              CAPACITY0_KERNELS, MEMORY_KERNELS, None,
              {"rel_attention_bwd": 6, "ffn_block_bwd": 6})


def _device_busy(prof) -> tuple:
    """(ms during which the card ran a kernel or a copy: the union of the
    traced device intervals, {kernel name: device ms}) of a
    ``torch.profiler`` trace."""
    import torch

    spans, per = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        per[e.name] = per.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy, end = 0.0, float("-inf")
    for start, stop in sorted(spans):
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy / 1e3, per


def time_eval_window(card: str) -> None:
    """``--eval_window``: phase 5's eval (``Trainer.evaluate("valid")`` at
    ``EvaluateConfig()``) ``EVAL_PASSES`` times in float32 and bfloat16,
    each pass on a new Trainer as phase 5 builds it, by the host's clock
    (the first pass of each dtype pays the process's one-time costs), then
    once more under ``torch.profiler``: the card's busy time (the union of
    its kernels' and copies' intervals) and idle share of that pass, and
    the device time of the memory forward (#2) and of the largest kernels,
    per window.  First it prints a hash of the SASS of each kernel of
    ``rel_attention_mem_fwd.cu`` in the built library (``cuobjdump``; the
    name line left out and the anonymous namespace's per-file tag blanked),
    so two trees' device code for #2 can be compared.  Run in turns with a
    copy of it in another commit's checkout."""
    import hashlib
    import re
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    from commu_tpu_torch.ops import _build
    from commu_tpu_torch.training import Trainer

    sass = subprocess.run(
        [str(Path(_build._nvcc()).parent / "cuobjdump"), "-sass",
         str(_build._library_path())], capture_output=True, text=True,
        check=True).stdout
    for block in re.split(r"\n\s*Function : ", sass)[1:]:
        name, body = block.split("\n", 1)
        if "rel_attention_mem_fwd" in name:
            body = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", body)
            print(f"[sass] rel_attention_mem_fwd.cu "
                  f"{_kernel_label(name.strip(), 'rel_attention_mem_fwd.cu')}"
                  f": sha1 {hashlib.sha1(body.encode()).hexdigest()[:16]} "
                  f"({body.count(';')} instructions) [{card}]")
    with tempfile.TemporaryDirectory() as tmp:
        write_corpus(Path(tmp) / "val", EVAL_LENGTHS, seed=3)
        for dtype in (torch.float32, torch.bfloat16):
            walls = []
            for _ in range(EVAL_PASSES + 1):
                trainer = Trainer(str(Path(tmp) / "val"), device="cuda",
                                  model_dtype=dtype)
                torch.cuda.synchronize()
                _build.reset_launches()
                t0 = time.perf_counter()
                trainer.evaluate("valid")
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                windows = _build.LAUNCHES["nll_fwd"]
            ms = [1e3 * w / windows for w in walls]
            warm = ms[1:]
            print(f"[eval_window] {dtype}: ms_per_window cold {ms[0]:.3f}, "
                  f"warm median {statistics.median(warm):.3f} (min "
                  f"{min(warm):.3f}, max {max(warm):.3f}; "
                  f"{', '.join(f'{x:.3f}' for x in warm)}) windows={windows} "
                  f"[{card}]")
            trainer = Trainer(str(Path(tmp) / "val"), device="cuda",
                              model_dtype=dtype)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                trainer.evaluate("valid")
                torch.cuda.synchronize()
                wall = 1e3 * (time.perf_counter() - t0)
            busy, per = _device_busy(prof)
            if busy <= 0:
                print(f"[eval_trace] {dtype}: not measured (the trace holds "
                      f"no device interval) [{card}]")
                continue
            mem_fwd = sum(v for k, v in per.items()
                          if "rel_attention_mem_fwd" in k)
            print(f"[eval_trace] {dtype}: traced pass {wall / windows:.3f} "
                  f"ms/window, device busy {busy / windows:.3f} ms/window, "
                  f"idle share {1 - busy / wall:.3f}, "
                  f"rel_attention_mem_fwd {mem_fwd / windows:.4f} ms/window "
                  f"[{card}]")
            for name, v in sorted(per.items(), key=lambda x: -x[1])[:6]:
                print(f"[eval_trace]   {v / windows:9.4f} ms/window  "
                      f"{name[:100]}")


def write_corpus(data_dir: Path, lengths, seed: int,
                 train_lengths=(300, 300)) -> None:
    """A synthetic corpus in the reference's npy layout, made with numpy: 11
    meta tokens in [560, 729) and events in [2, 560) per sequence, so that a
    sequence (after the BOS the dataset prepends) has the given length.
    Writes the val split (``lengths``) and the train split
    (``train_lengths``; the dataset loads both)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    data_dir.mkdir(parents=True, exist_ok=True)

    def split(name, lens):
        metas = np.empty(len(lens), dtype=object)
        events = np.empty(len(lens), dtype=object)
        for i, n in enumerate(lens):
            metas[i] = rng.randint(560, 729, size=11).astype(np.int64)
            events[i] = rng.randint(2, 560, size=n - 12).astype(np.int64)
        np.save(data_dir / f"input_{name}.npy", metas, allow_pickle=True)
        np.save(data_dir / f"target_{name}.npy", events, allow_pickle=True)

    split("train", list(train_lengths))
    split("val", list(lengths))


def check_eval_model(data_dir: Path, card: str) -> None:
    """Phase 4: a short full-width eval (batch 2, tgt 128, mem 256: two
    slabs, so the ring wraps) on the card against the same eval on the CPU
    (plain versions), f32, from the same seeded weights."""
    import torch

    from commu_tpu_torch.training import EvaluateConfig, Trainer, TrainingConfig

    cfg = TrainingConfig(evaluate=EvaluateConfig(batch_size=2, tgt_length=128,
                                                 mem_length=256))
    totals = {}
    for dev in ("cuda", "cpu"):
        trainer = Trainer(str(data_dir), cfg, device=dev,
                          model_dtype=torch.float32)
        totals[dev] = trainer.evaluate("valid")
    (tok_c, nll_c), (tok_p, nll_p) = totals["cuda"], totals["cpu"]
    if tok_c != tok_p or abs(nll_c - nll_p) > MODEL_TOL * abs(nll_p):
        raise AssertionError(f"eval card vs CPU: tokens {tok_c} vs {tok_p}, "
                             f"nll_sum {nll_c} vs {nll_p} (rtol {MODEL_TOL})")
    print(f"[eval-model] ModelConfig() batch 2 tgt 128 mem 256, card vs CPU: "
          f"tokens={tok_c} nll_sum={nll_c:.6f} vs {nll_p:.6f} "
          f"rel_err={abs(nll_c - nll_p) / abs(nll_p):.3e} "
          f"(rtol={MODEL_TOL}) [{card}]")


def evaluate(data_dir: Path, card: str) -> dict:
    """Phase 5: Trainer.evaluate("valid") at ModelConfig() and
    EvaluateConfig(), in float32 and bfloat16; returns the launches per
    kernel summed over both runs."""
    import math

    import torch

    from commu_tpu_torch.ops import _build
    from commu_tpu_torch.training import Trainer

    launches = {name: 0 for name in _build.LAUNCHES}
    for dtype in (torch.float32, torch.bfloat16):
        trainer = Trainer(str(data_dir), device="cuda", model_dtype=dtype)
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        tokens, nll_sum = trainer.evaluate("valid")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        run = dict(_build.LAUNCHES)
        nll = nll_sum / max(tokens, 1)
        if not math.isfinite(nll) or tokens <= 0:
            raise AssertionError(f"eval {dtype}: tokens {tokens}, nll {nll}")
        missing = [k for k in EVAL_KERNELS if run[k] <= 0]
        if missing:
            raise AssertionError(f"eval {dtype}: kernels {missing} never "
                                 "launched")
        windows = run["nll_fwd"]  # one per window
        print(f"[eval] ModelConfig() EvaluateConfig() {dtype}: tokens={tokens} "
              f"val_nll={nll:.6f} wall_s={wall:.3f} windows={windows} "
              f"ms_per_window={1e3 * wall / windows:.3f} "
              f"eval_tokens/s={tokens / wall:.1f} launches={run} [{card}]")
        for name, n in run.items():
            launches[name] += n
    return launches


def check_train_model(card: str, dropout_p: float, m_cap: int = 256,
                      fast: bool = False) -> None:
    """Phase 6: four train steps at ModelConfig() width with dropout and
    attention dropout at ``dropout_p``, batch 4, batch_chunk 2, tgt 128, mem
    ``m_cap`` (256 is two slabs: the ring fills, then wraps; 0 is training
    without XL memory, and the memory must then stay at capacity 0 after
    every step), f32, on the card (kernels)
    and on the CPU (plain versions), from the same seeded weights, batches
    and, with dropout, the same per-step seeds and psi mask (the step's
    default draw follows the run's seed and the step, on the host).
    nll_sum and grad_norm agree to
    rtol MODEL_TOL per step; every parameter agrees within 2 x the sum of
    the learning rates applied (Adam moves an element by up to about lr a
    step, so a sign flip of a near-zero gradient can move it that far).
    ``fast``: with the three levers of the fast mode set for both sides
    (int8 BD forward, int8 dphi backward, 8-bit draws), at the same
    tolerances: the card's int8 kernels against the CPU's integer matmuls."""
    import dataclasses
    import os

    import numpy as np
    import torch

    from commu_tpu_torch.models import (VOCAB_SIZE, ModelConfig, TransformerXL,
                                        init_memory, memory_capacity)
    from commu_tpu_torch.training import (TrainConfig, TrainingConfig,
                                          make_optimizer, make_train_step)
    from commu_tpu_torch.training.schedule import lr_at

    b, t, steps = 4, 128, 4
    mcfg = dataclasses.replace(ModelConfig(), dropout=dropout_p,
                               attention_dropout=dropout_p)
    cfg = TrainingConfig(model=mcfg, train=TrainConfig(
        batch_size=b, batch_chunk=2, tgt_length=t, mem_length=m_cap,
        warmup_step=3))
    rng = np.random.RandomState(5)
    batches = []
    for i in range(steps):
        inputs = rng.randint(1, VOCAB_SIZE, size=(b, t)).astype(np.int32)
        targets = rng.randint(1, VOCAB_SIZE, size=(b, t)).astype(np.int32)
        targets[1, 90:] = 0  # PAD targets
        reset = np.array([False, False, i == 2, False])
        batches.append((inputs, targets, reset))
    metrics, params = {}, {}
    env = FAST_ENV if fast else {}
    saved_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        for dev in ("cuda", "cpu"):
            model = TransformerXL(VOCAB_SIZE, mcfg, dtype=torch.float32)
            model.init_parameters(torch.Generator().manual_seed(0))
            model = model.to(dev)
            opt, sched = make_optimizer(model, cfg)
            step = make_train_step(model, opt, sched, cfg)
            memory = init_memory(mcfg.num_layers, b, m_cap, mcfg.units,
                                 dtype=torch.float32, block_len=t, device=dev)
            metrics[dev] = []
            for inputs, targets, reset in batches:
                memory, m = step(memory, *(torch.from_numpy(x).to(dev)
                                           for x in (inputs, targets, reset)))
                metrics[dev].append({k: float(v) for k, v in m.items()})
                if memory_capacity(memory) != m_cap:
                    raise AssertionError(
                        f"memory capacity {memory_capacity(memory)} after a "
                        f"step, expected {m_cap}")
            params[dev] = {k: v.detach().cpu() for k, v in
                           model.state_dict().items()}
    finally:
        for key, value in saved_env.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
    mode = " fast mode" if fast else ""
    for i, (mc, mp) in enumerate(zip(metrics["cuda"], metrics["cpu"])):
        if mc["token_count"] != mp["token_count"]:
            raise AssertionError(f"train step {i}: token counts differ")
        for name in ("nll_sum", "grad_norm"):
            if not abs(mc[name] - mp[name]) <= MODEL_TOL * abs(mp[name]):
                raise AssertionError(f"train step {i} {name}: card "
                                     f"{mc[name]} vs CPU {mp[name]}")
        print(f"[train-model]{mode} dropout {dropout_p} mem {m_cap} step {i}: "
              f"nll_sum={mc['nll_sum']:.6f} vs "
              f"{mp['nll_sum']:.6f} grad_norm={mc['grad_norm']:.6f} vs "
              f"{mp['grad_norm']:.6f} tokens={mc['token_count']:.0f} "
              f"(rtol={MODEL_TOL}) [{card}]")
    bound = 2 * sum(lr_at(cfg.train, i) for i in range(steps))
    worst = max((params["cuda"][k] - params["cpu"][k]).abs().max().item()
                for k in params["cpu"])
    if not worst <= bound:
        raise AssertionError(f"train params: max |card - CPU| {worst:.3e} "
                             f"> {bound:.3e}")
    print(f"[train-model]{mode} ModelConfig() dropout {dropout_p}, batch 4, tgt 128, "
          f"mem {m_cap}, {steps} steps f32: max |param card - CPU|={worst:.3e} "
          f"(atol=2*sum(lr)={bound:.3e}) [{card}]")


def train(data_dir: Path, work_dir: Path, card: str, dropout: bool,
          dtypes, steps: int, flags=(), wanted=None, unwanted=(), env=None,
          launches_per_step=None, precise=True, corpus_tokens=None,
          records=None):
    """Phase 7: ``python -m commu_tpu_torch.train`` in-process at the
    reference shape (TrainConfig(): batch 256, batch_chunk 4, tgt 128, mem
    1024), once per dtype, ``steps`` steps, log every 4, eval, checkpoints
    and the test pass at the last step, then final_test.  ``dropout``:
    ModelConfig() unchanged (dropout and attention dropout 0.1, no ``--set``
    on the model); else both set to 0.  ``flags``: further CLI flags (the
    run without XL memory sets ``train.mem_length=0``); ``env``: environment
    variables set for the run (the fused probes) and restored after it.
    ``precise``: pass ``--precise_bd`` (the exact mode); without it the CLI
    runs in its default fast mode, and must leave the three levers out of
    ``os.environ`` again.
    ``wanted`` kernels must have launched (default: the training kernels),
    ``unwanted`` ones must not, and ``launches_per_step`` names kernels with
    the exact launches a train step makes of each.  The train step is
    wrapped to synchronize after each step, so ms/step is a host-clock time
    from step 3 on, after two warm-up steps.  ``corpus_tokens``: the train
    split's tokens, to print the epochs the steps covered.  ``records``: a
    dict that receives each dtype's steps as (host clock after the step's
    sync, nll_sum, token_count, grad_norm).  Returns (the launches per
    kernel summed over the runs, each dtype's ``nll_sum`` per step)."""
    import math
    import os

    import torch

    from commu_tpu_torch import train as train_cli
    from commu_tpu_torch.ops import _build
    from commu_tpu_torch.training import loop

    make_step = loop.make_train_step
    record = []

    def timed_make_train_step(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def timed(memory, inputs, targets, reset):
            out = step(memory, inputs, targets, reset)
            torch.cuda.synchronize()
            m = out[1]
            record.append((time.perf_counter(), float(m["nll_sum"]),
                           float(m["token_count"]), float(m["grad_norm"])))
            return out
        return timed

    launches = {name: 0 for name in _build.LAUNCHES}
    nll_sums = {}
    env = dict(env or {})
    saved_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    loop.make_train_step = timed_make_train_step
    try:
        model_flags = [] if dropout else [
            "--set", "model.dropout=0.0",
            "--set", "model.attention_dropout=0.0"]
        model_name = "ModelConfig()" if dropout else "ModelConfig() dropout 0"
        model_name += " --precise_bd" if precise else " fast mode (default)"
        mode_flags = ["--precise_bd"] if precise else []
        if flags or env:
            model_name += " " + " ".join(
                [f for f in flags if f != "--set"]
                + [f"{k}={v}" for k, v in env.items()])
        if wanted is None:
            wanted = DROPOUT_TRAIN_KERNELS if dropout else TRAIN_KERNELS
        for dtype in dtypes:
            record.clear()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _build.reset_launches()
            t0 = time.perf_counter()
            work = train_cli.main([
                "--data_dir", str(data_dir), "--work_dir",
                str(work_dir / dtype), "--dtype", dtype, "--max_step",
                str(steps), *model_flags, *mode_flags,
                "--set", "train.log_interval=4",
                "--set", f"train.eval_interval={steps}", *flags])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            run = dict(_build.LAUNCHES)
            peak = torch.cuda.max_memory_allocated() / 2 ** 20
            log = (Path(work) / "train.log").read_text()
            left = [k for k in FAST_ENV if k in os.environ and k not in env]
            if left:
                raise AssertionError(f"train {dtype}: the CLI left {left} in "
                                     "os.environ")
            want_mode = "numerics: " + ", ".join(
                f"{k}={'0' if precise and v == '1' else '16' if precise else v}"
                for k, v in FAST_ENV.items())
            if want_mode not in log:
                raise AssertionError(f"train {dtype}: no '{want_mode}' line")
            if len(record) != steps:
                raise AssertionError(f"train {dtype}: {len(record)} steps ran")
            for _, nll_sum, tokens, gnorm in record:
                if not (math.isfinite(nll_sum) and math.isfinite(gnorm)
                        and tokens > 0):
                    raise AssertionError(f"train {dtype}: nll_sum {nll_sum}, "
                                         f"grad norm {gnorm}, tokens {tokens}")
            evaluated = "train.eval_interval=1000" not in flags
            needles = ["End of training | test nll"]
            if steps >= 4:
                needles.append(f"Train Step {steps // 4 * 4}/{steps}")
            if evaluated:
                needles += [f"Eval step {steps}", f"Test step {steps}"]
            for needle in needles:
                if needle not in log:
                    raise AssertionError(f"train {dtype}: no '{needle}' line")
            test_nll = float(log.split("End of training | test nll")[1]
                             .split("|")[0])
            if not math.isfinite(test_nll):
                raise AssertionError(f"train {dtype}: test nll {test_nll}")
            for name in (("checkpoint_last.pt", "checkpoint_best.pt")
                         if evaluated else ()) + ("config.yml",):
                if not (Path(work) / name).is_file():
                    raise AssertionError(f"train {dtype}: no {name}")
            missing = [k for k in wanted if run[k] <= 0]
            if missing:
                raise AssertionError(f"train {dtype}: kernels {missing} never "
                                     "launched")
            if not dropout and run["dropout_bdt"]:
                raise AssertionError("dropout_bdt launched at dropout 0")
            stray = [k for k in unwanted if run[k] > 0]
            if stray:
                raise AssertionError(f"train {dtype} {model_name}: kernels "
                                     f"{stray} launched")
            for name, per_step in (launches_per_step or {}).items():
                # the eval and test passes launch forward kernels too: a
                # backward kernel's count is the train steps' alone
                if run[name] != per_step * steps:
                    raise AssertionError(
                        f"train {dtype}: {name} launched {run[name]} times in "
                        f"{steps} steps, expected {per_step} a step")
            nll_sums[dtype] = [r[1] for r in record]
            if records is not None:
                records[dtype] = list(record)
            timed_s = record[-1][0] - record[1][0]
            tokens = sum(r[2] for r in record[2:])
            nll = sum(r[1] for r in record) / sum(r[2] for r in record)
            epochs = (f"epochs={sum(r[2] for r in record) / corpus_tokens:.4f} "
                      if corpus_tokens else "")
            print(f"[train] python -m commu_tpu_torch.train, TrainConfig() "
                  f"{model_name}, {dtype}: {steps} steps "
                  f"ms/step={1e3 * timed_s / (steps - 2):.1f} "
                  f"(steps 3-{steps}) "
                  f"train_tokens/s={tokens / timed_s:.1f} "
                  f"to_step_1_s={record[0][0] - t0:.2f} train_nll={nll:.4f} "
                  f"last_grad_norm={record[-1][3]:.4f} test_nll={test_nll:.4f} "
                  f"{epochs}"
                  f"peak_mem_MiB={peak:.1f} wall_s={wall:.1f} "
                  f"launches={run} [{card}]")
            for name, n in run.items():
                launches[name] += n
    finally:
        loop.make_train_step = make_step
        for key, value in saved_env.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
    return launches, nll_sums


def probes(data_dir: Path, work_dir: Path, card: str, base_nll) -> dict:
    """Phase 9: the CLI at the reference shape in float32 with the fused
    probes switched on, three steps and ``final_test`` each (the test pass
    is ``Trainer.evaluate`` under the same variables): first
    ``COMMU_PROJ_IN_FWD=1`` alone, then ``COMMU_O_IN_FFN=1`` as well; each
    step's ``nll_sum`` must lie within rtol ``MODEL_TOL`` of ``base_nll``
    (the default path's, from the same weights, batches and seeds): the
    fused o = Wo^T vec sums in another order and stays f32 where the default
    path's o is a cuBLAS product, and the fused backward's dvec and dWo sum
    in other orders than autograd's.  Returns the launches per kernel summed
    over the two runs."""
    from commu_tpu_torch.ops import _build

    total = {name: 0 for name in _build.LAUNCHES}
    steps = 3
    common = dict(
        flags=["--set", "train.eval_interval=1000"],
        unwanted=("project_mem_kv", "rel_attention_fwd", "rel_attention_bwd"))
    runs = (
        ({"COMMU_PROJ_IN_FWD": "1"}, MODEL_TOL,
         ("rel_attention_proj_fwd", "rel_attention_mem_bwd", "ffn_block_fwd",
          "ffn_block_bwd"), {"rel_attention_mem_bwd": 6, "ffn_block_bwd": 6}),
        ({"COMMU_PROJ_IN_FWD": "1", "COMMU_O_IN_FFN": "1"}, MODEL_TOL,
         ("rel_attention_proj_fwd", "rel_attention_mem_bwd",
          "ffn_block_fused_o_fwd", "ffn_block_fused_o_bwd"),
         {"rel_attention_mem_bwd": 6, "ffn_block_fused_o_bwd": 6,
          "ffn_block_fwd": 0, "ffn_block_bwd": 0}))
    for i, (env, rtol, wanted, per_step) in enumerate(runs):
        launches, nll = train(
            data_dir, work_dir / f"probe{i}", card, True, ("float32",), steps,
            env=env, wanted=wanted + ("nll_fwd", "nll_bwd", "embed_grad",
                                      "dropout_bdt", "ring_write_layer"),
            launches_per_step=per_step, **common)
        for step, (ours, ref) in enumerate(zip(nll["float32"], base_nll)):
            if not abs(ours - ref) <= rtol * abs(ref):
                raise AssertionError(
                    f"probe {env} step {step}: nll_sum {ours!r} vs the "
                    f"default path's {ref!r} (rtol {rtol})")
        worst = max(abs(a - r) / abs(r)
                    for a, r in zip(nll["float32"], base_nll))
        print(f"[probe] {' '.join(f'{k}={v}' for k, v in env.items())}: "
              f"{steps} steps, nll_sum vs the default path: max rel diff "
              f"{worst:.3e} (rtol={rtol}) [{card}]")
        for name, n in launches.items():
            total[name] += n
    return total


# phase 10's raw corpus: clips per split, each 8 bars of 4/4
# the JAX package's 2,000-step run at the shipped defaults (bf16, int8 BD,
# 8-bit dropout, TrainConfig()) over scripts/make_synthetic_corpus.py --n
# 400, BASELINE_train2k_int8.log: train (nll, grad norm) and val nll by
# step, and its ms a step from step 100 to 1000 (on its TPU: a record of
# that run, no yardstick of the port's)
CONVERGE_CLIPS = 400
CONVERGE_STEPS = 2000
CONVERGE_SHORT_STEPS = 100
JAX_TRAIN = {100: (5.5756, 1.8933), 500: (5.0224, 0.4820),
             1000: (5.0128, 0.4895), 2000: (4.9874, 0.4413)}
JAX_VAL = {1000: 5.1671, 2000: 4.9964}
JAX_MS_PER_STEP = 139.3
# val nll at the last step within 2% of the JAX run's (ROADMAP C3); the
# short form's train nll at step 100 under 6.0 (the JAX run reads 5.58
# there, a uniform guess over the 729 tokens ln 729 = 6.59)
CONVERGE_VAL_RTOL = 0.02
CONVERGE_SHORT_NLL = 6.0


def parse_train_log(text: str, last: int):
    """The train CLI's log (the JAX package's format): {step: (train nll,
    grad norm)}, {step: val nll}, the ms a step between the first logged
    step and the last one at or before ``last`` by the log's clock, and
    those two steps."""
    import datetime
    import re

    stamp = r"^(\S+ \S+) - ComMU - INFO - "
    train, val, when = {}, {}, {}
    for line in text.splitlines():
        m = re.match(stamp + r"Train Step (\d+)/\d+, .*nll=(\S+), ppl=\S+, "
                     r"grad norm=(\S+)", line)
        if m:
            step = int(m.group(2))
            train[step] = (float(m.group(3)), float(m.group(4)))
            when[step] = datetime.datetime.strptime(
                m.group(1), "%Y-%m-%d %H:%M:%S,%f")
        m = re.match(stamp + r"Eval step (\d+), .*val nll=(\S+),", line)
        if m:
            val[int(m.group(2))] = float(m.group(3))
    logged = [k for k in sorted(when) if k <= last] or [0]
    ms = ((when[logged[-1]] - when[logged[0]]).total_seconds() * 1e3
          / (logged[-1] - logged[0]) if len(logged) > 1 else float("nan"))
    return train, val, ms, (logged[0], logged[-1])


def converge_phase(root: Path, card: str, steps: int = CONVERGE_STEPS) -> None:
    """``[converge]``: ``python -m commu_tpu_torch.data.synthetic --n 400``
    (the JAX package's synthetic corpus, seed 1111: 360 train and 40 val
    clips), then ``python -m commu_tpu_torch.train --max_step steps --dtype
    bfloat16`` on it in a subprocess, in the CLI's default fast mode at
    ``TrainConfig()`` and ``ModelConfig()`` (logs every 100 steps, an eval
    every 1,000).  Prints train nll and grad norm at steps 100, 500, 1000
    and 2000, val nll at 1000 and 2000, and ms a step from step 100 to
    the last log before the first eval, each beside the JAX log's.  Fails
    on a NaN, and at 2,000 steps when val nll at step 2000 is not within
    ``CONVERGE_VAL_RTOL`` of the JAX run's; the default run's short form
    (100 steps) fails when train nll at step 100 is not under
    ``CONVERGE_SHORT_NLL``."""
    import math

    data, work = root / "corpus", root / "run"
    t0 = time.perf_counter()
    made = subprocess.run(
        [sys.executable, "-m", "commu_tpu_torch.data.synthetic", str(data),
         "--n", str(CONVERGE_CLIPS)], capture_output=True, text=True,
        timeout=600)
    if made.returncode != 0:
        raise AssertionError(f"synthetic corpus: {made.stderr[-3000:]}")
    corpus_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "commu_tpu_torch.train", "--data_dir",
         str(data), "--work_dir", str(work), "--max_step", str(steps),
         "--dtype", "bfloat16"], capture_output=True, text=True,
        timeout=1800)
    run_s = time.perf_counter() - t0
    (root / "train.log").write_text(run.stdout + run.stderr)
    if run.returncode != 0:
        raise AssertionError(f"train CLI exit {run.returncode}: "
                             f"{(run.stdout + run.stderr)[-3000:]}")
    train, val, ms, logged = parse_train_log(run.stdout, min(1000, steps))
    print(f"[converge] corpus {made.stdout.strip()} ({corpus_s:.1f} s); "
          f"train CLI {steps} steps, fast mode, bf16: {run_s:.1f} s "
          f"[{card}]")
    for step in (100, 500, 1000, 2000):
        if step in train:
            jax = JAX_TRAIN[step]
            print(f"[converge] step {step}: train nll {train[step][0]!r} "
                  f"(JAX log {jax[0]}), grad norm {train[step][1]!r} "
                  f"(JAX log {jax[1]}) [{card}]")
        if step in val:
            print(f"[converge] step {step}: val nll {val[step]!r} (JAX log "
                  f"{JAX_VAL[step]}, {val[step] / JAX_VAL[step] - 1:+.4f}) "
                  f"[{card}]")
    if logged[0] < logged[1]:
        print(f"[converge] ms a step, steps {logged[0]}-{logged[1]} by the "
              f"log's clock: {ms:.2f} (the JAX log's {JAX_MS_PER_STEP}, on "
              f"its TPU) [{card}]")
    values = [v for pair in train.values() for v in pair] + list(val.values())
    if not train or not all(math.isfinite(v) for v in values):
        raise AssertionError(f"converge: a non-finite or missing reading "
                             f"{train} {val}")
    if steps >= CONVERGE_STEPS:
        last = val.get(CONVERGE_STEPS)
        if last is None or abs(last / JAX_VAL[CONVERGE_STEPS] - 1) \
                > CONVERGE_VAL_RTOL:
            raise AssertionError(
                f"converge: val nll {last} at step {CONVERGE_STEPS}, not "
                f"within {CONVERGE_VAL_RTOL} of the JAX run's "
                f"{JAX_VAL[CONVERGE_STEPS]}")
    elif not train[CONVERGE_SHORT_STEPS][0] < CONVERGE_SHORT_NLL:
        raise AssertionError(
            f"converge: train nll {train[CONVERGE_SHORT_STEPS][0]} at step "
            f"{CONVERGE_SHORT_STEPS}, not under {CONVERGE_SHORT_NLL}")


CHAIN_CLIPS = (("train", 16), ("val", 4))
CHAIN_SEED = 15
CHAIN_CHORDS = ("C", "F", "G", "Am", "Dm", "Em", "A#")
# the columns of the metadata CSV, after an unnamed index column
CHAIN_COLUMNS = ("audio_key", "chord_progressions", "pitch_range",
                 "num_measures", "bpm", "genre", "track_role", "inst",
                 "sample_rhythm", "time_signature", "min_velocity",
                 "max_velocity", "split_data", "id")
CHAIN_STEPS = 4
CHAIN_GENERATE = 8


def write_raw_corpus(root: Path, clips=CHAIN_CLIPS, seed: int = CHAIN_SEED):
    """The corpus chain's raw input, written with the port's own ``midi``:
    per clip a seeded single-track melody of 8 bars in 4/4 at 480 ticks a
    beat, four notes a bar (velocity 40-100, pitch 48-84), one chord a bar,
    at a BPM drawn from [60, 150), in ``root/{split}/raw/``, and its row in
    ``root/commu_meta.csv`` (an unnamed index column first, as pandas writes
    one; written with ``csv``).  The first clip is in D major, so the
    preprocess drops its variants; the second holds pitch 125, so its
    transposes by +3, +4 and +5 semitones leave the MIDI range and are
    skipped; the others alternate C major and A minor.  Returns the CSV's
    path, its rows, and per split the variants the preprocess must encode:
    12 keys x 5 BPMs of every kept parent, less 5 for each skipped key."""
    import csv
    import random

    from commu_tpu_torch.midi import (Instrument, KeySignature, MidiFile,
                                      Note, TempoChange, TimeSignature)
    from commu_tpu_torch.utils.constants import NUM_BPM_AUGMENT, \
        NUM_KEY_AUGMENT

    tpb, bars, per_bar = 480, 8, 4
    step = tpb * 4 // per_bar
    rows, expected, idx = [], {}, 0
    for split, count in clips:
        raw = root / split / "raw"
        raw.mkdir(parents=True, exist_ok=True)
        expected[split] = 0
        for _ in range(count):
            idx += 1
            rng = random.Random(seed * 1000 + idx)
            key, key_number = (("dmajor", 2) if idx == 1 else
                               ("cmajor", 0) if idx % 2 else ("aminor", 21))
            bpm = rng.randrange(60, 150)
            midi = MidiFile(ticks_per_beat=tpb)
            midi.tempo_changes = [TempoChange(tempo=float(bpm), time=0)]
            midi.time_signature_changes = [TimeSignature(4, 4, 0)]
            midi.key_signature_changes = [KeySignature(key_number=key_number)]
            inst = Instrument(program=0, name="melody")
            for start in range(0, bars * per_bar * step, step):
                inst.notes.append(Note(velocity=rng.randint(40, 100),
                                       pitch=rng.randint(48, 84),
                                       start=start, end=start + step))
            if idx == 2:
                inst.notes[0].pitch = 125
            midi.instruments = [inst]
            sample_id = f"commu{idx:05d}"
            midi.dump(raw / f"{sample_id}.mid")
            chords = [c for _ in range(bars)
                      for c in [rng.choice(CHAIN_CHORDS)] * 8]
            velocities = [n.velocity for n in inst.notes]
            rows.append({
                "audio_key": key, "chord_progressions": [chords],
                "pitch_range": "mid", "num_measures": float(bars), "bpm": bpm,
                "genre": ("newage", "cinematic")[idx % 2],
                "track_role": "main_melody", "inst": "acoustic_piano",
                "sample_rhythm": "standard", "time_signature": "4/4",
                "min_velocity": min(velocities),
                "max_velocity": max(velocities), "split_data": split,
                "id": sample_id})
            if key in ("cmajor", "aminor"):
                pitches = [n.pitch for n in inst.notes]
                keys = sum(0 <= min(pitches) + shift and
                           max(pitches) + shift <= 127
                           for shift in range(-NUM_KEY_AUGMENT,
                                              NUM_KEY_AUGMENT))
                expected[split] += keys * (2 * NUM_BPM_AUGMENT + 1)
    csv_path = root / "commu_meta.csv"
    with open(csv_path, "w", newline="") as fh:
        writer = csv.writer(fh)
        writer.writerow(("",) + CHAIN_COLUMNS)
        for i, row in enumerate(rows):
            writer.writerow([i] + [row[c] for c in CHAIN_COLUMNS])
    return csv_path, rows, expected


def _parse_seconds(paths, parse) -> float:
    """Host seconds to read and parse every file of ``paths`` with
    ``parse`` (a ``MidiFile`` method taking the bytes)."""
    from commu_tpu_torch.midi import MidiFile

    t0 = time.perf_counter()
    for path in paths:
        parse(MidiFile(ticks_per_beat=0), Path(path).read_bytes())
    return time.perf_counter() - t0


def native_parse_times(dataset: Path, parser: str, card: str) -> None:
    """``[native]``: the preprocess's parser (``parser``: its library's
    path, from the CLI's process) must be the port's native library, built
    from ``midi/native/smf_native.cpp``; then the host seconds to parse the
    raw clips and their augmented variants with it and with the Python
    parser, which must give the same objects."""
    from commu_tpu_torch.midi import _native_build, smf

    lib_path = _native_build.library_path()
    if parser == "None" or Path(parser).resolve() != lib_path.resolve():
        raise AssertionError(f"the preprocess parsed with {parser}, not the "
                             f"native library {lib_path}")
    lib = smf._load_native()
    if lib is None or Path(lib._name).resolve() != lib_path.resolve():
        raise AssertionError(f"the native parser is not loaded here: {lib}")
    for sub in ("raw", "augmented"):
        paths = sorted(dataset.glob(f"*/{sub}/*.mid"))
        native = _parse_seconds(
            paths, lambda m, blob: m._parse_native(lib, blob))
        python = _parse_seconds(paths, smf.MidiFile._parse_python)
        for path in paths[:: max(1, len(paths) // 50)]:
            a, b = (smf.MidiFile(ticks_per_beat=0) for _ in range(2))
            blob = path.read_bytes()
            a._parse_native(lib, blob)
            b._parse_python(blob)
            if (a.ticks_per_beat, a.instruments, a.tempo_changes,
                    a.key_signature_changes) != (
                    b.ticks_per_beat, b.instruments, b.tempo_changes,
                    b.key_signature_changes):
                raise AssertionError(f"{path.name}: the parsers differ")
        print(f"[native] {lib_path} ({lib_path.stat().st_size} bytes): "
              f"{len(paths)} {sub} files parsed in {native:.3f} s native, "
              f"{python:.3f} s Python ({1e6 * native / len(paths):.1f} / "
              f"{1e6 * python / len(paths):.1f} us a file) [{card}]")


def parse_profile(root: Path, clips: int) -> None:
    """``--parse N``: the preprocess at a corpus's size on the host alone,
    its stages timed apart.  Writes ``clips`` seeded raw clips (a tenth of
    them val) with ``write_raw_corpus``, parses every raw clip with the
    native and the Python parser, then runs ``Preprocessor.preprocess`` at
    ``--num_cores`` = the host's cores (up to 8) with its stages wrapped in
    host clocks: augment (``augment.augment_data``), encode
    (``export_encoded_midi``) and concat (``concat_npy``), then parses up
    to 20,000 of the augmented variants with each parser.  ``[parse]``
    lines; no card is needed."""
    import numpy as np

    from commu_tpu_torch.midi import smf
    from commu_tpu_torch.preprocess import augment, preprocessor

    cores = min(8, os.cpu_count() or 1)
    val = max(1, clips // 10)
    t0 = time.perf_counter()
    csv_path, _, expected = write_raw_corpus(
        root, (("train", clips - val), ("val", val)))
    print(f"[parse] wrote {clips} raw clips in {time.perf_counter() - t0:.3f}"
          f" s; {sum(expected.values())} variants expected; {cores} cores")
    lib = smf._load_native()
    raw = sorted(root.glob("*/raw/*.mid"))
    native = _parse_seconds(raw, lambda m, blob: m._parse_native(lib, blob))
    python = _parse_seconds(raw, smf.MidiFile._parse_python)
    print(f"[parse] parse {len(raw)} raw clips: native {native:.3f} s, "
          f"Python {python:.3f} s")
    spent = {"augment": 0.0, "encode": 0.0, "concat": 0.0}

    def timed(stage, fn):
        def run(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent[stage] += time.perf_counter() - t
        return run

    patches = ((augment, "augment_data", "augment"),
               (preprocessor.Preprocessor, "export_encoded_midi", "encode"),
               (preprocessor, "concat_npy", "concat"))
    originals = [getattr(obj, name) for obj, name, _ in patches]
    for (obj, name, stage), fn in zip(patches, originals):
        setattr(obj, name, timed(stage, fn))
    t0 = time.perf_counter()
    try:
        preprocessor.Preprocessor(csv_path).preprocess(root, cores)
    finally:
        for (obj, name, _), fn in zip(patches, originals):
            setattr(obj, name, fn)
    total = time.perf_counter() - t0
    for split, want in expected.items():
        got = len(np.load(root / "output_npy" / f"input_{split}.npy",
                          allow_pickle=True))
        if got != want:
            raise AssertionError(f"--parse {split}: {got} sequences, {want} "
                                 "expected")
    print(f"[parse] preprocess {clips} clips at --num_cores {cores}: "
          f"{total:.3f} s: augment {spent['augment']:.3f} s, encode "
          f"{spent['encode']:.3f} s, concat {spent['concat']:.3f} s, the rest "
          f"{total - sum(spent.values()):.3f} s")
    variants = sorted(root.glob("*/augmented/*.mid"))
    sample = variants[:: max(1, len(variants) // 20000)]
    native = _parse_seconds(sample, lambda m, blob: m._parse_native(lib, blob))
    python = _parse_seconds(sample, smf.MidiFile._parse_python)
    print(f"[parse] parse {len(sample)} of {len(variants)} augmented variants:"
          f" native {native:.3f} s, Python {python:.3f} s "
          f"({1e6 * native / len(sample):.1f} / "
          f"{1e6 * python / len(sample):.1f} us a file)")


def corpus_chain(root: Path, card: str) -> dict:
    """Phase 10: the reference's three CLIs as one chain, on the card.
    Writes the raw corpus (``write_raw_corpus``), runs ``python -m
    commu_tpu_torch.preprocess --num_cores 4`` in a subprocess (its pool
    forks away from this process's CUDA context) and holds each split's
    sequences to the variants expected; trains on ``root/output_npy`` with
    the train CLI in-process at ``TrainConfig()`` and ``ModelConfig()``,
    fast mode, bfloat16, ``CHAIN_STEPS`` steps with an eval and both
    checkpoints (``train``'s checks, and the epochs the steps covered); then
    ``python -m commu_tpu_torch.generate --num_generate 8 --lenient`` at the
    default length in-process from that run's ``checkpoint_best.pt``, on the
    metadata and chords of the first val record: the episode must have been
    captured and replayed, #1, #7 and #15 launched (#15 once per decode and
    warm-up step), and every ``.mid`` of the output parses back.  Returns
    the launches per kernel of the train run and the generation."""
    import numpy as np
    import torch

    from commu_tpu_torch import generate, generation
    from commu_tpu_torch.data.dataset import ComMUDataset
    from commu_tpu_torch.generation.postprocess import read_midi
    from commu_tpu_torch.ops import _build

    csv_path, rows, expected = write_raw_corpus(root / "dataset")
    # the CLI as ``python -m`` runs it, then its MIDI parser's library
    argv = ["preprocess", "--root_dir", str(root / "dataset"), "--csv_path",
            str(csv_path), "--num_cores", "4"]
    code = ("import runpy, sys\n"
            f"sys.argv = {argv!r}\n"
            "runpy.run_module('commu_tpu_torch.preprocess', "
            "run_name='__main__', alter_sys=True)\n"
            "from commu_tpu_torch.midi import smf\n"
            "print('[parser]', smf._NATIVE_LIB._name if smf._NATIVE_LIB "
            "else None)\n")
    env = {k: v for k, v in os.environ.items() if k != "COMMU_TPU_NO_NATIVE"}
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=Path(__file__).resolve().parent,
        capture_output=True, text=True, timeout=600, env=env)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"preprocess exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    parser = proc.stdout.splitlines()[-1].split(maxsplit=1)[1]
    native_parse_times(root / "dataset", parser, card)
    data_dir = root / "dataset" / "output_npy"
    for split, want in expected.items():
        inputs = np.load(data_dir / f"input_{split}.npy", allow_pickle=True)
        targets = np.load(data_dir / f"target_{split}.npy", allow_pickle=True)
        if len(inputs) != want or len(targets) != want:
            raise AssertionError(f"preprocess {split}: {len(inputs)} inputs, "
                                 f"{len(targets)} targets, {want} expected")
        events = sum(len(t) for t in targets)
        print(f"[chain] preprocess {split}: {dict(CHAIN_CLIPS)[split]} clips "
              f"-> sequences={want} meta+event tokens="
              f"{events + sum(len(m) for m in inputs)} event tokens={events}")
    print(f"[chain] python -m commu_tpu_torch.preprocess --num_cores 4: "
          f"{seconds:.3f} s [{card}]")

    corpus_tokens = ComMUDataset(data_dir).num_tokens("train")
    print(f"[chain] the next [train] line: python -m commu_tpu_torch.train "
          f"--data_dir {data_dir.name}, {corpus_tokens} train tokens")
    launches, _ = train(
        data_dir, root / "runs", card, True, ("bfloat16",), CHAIN_STEPS, (),
        FAST_TRAIN_KERNELS, FAST_UNWANTED, None,
        {"rel_attention_mem_bwd[int8]": 6, "ffn_block_bwd[bits8]": 6}, False,
        corpus_tokens=corpus_tokens)
    best = sorted((root / "runs").rglob("checkpoint_best.pt"))
    if len(best) != 1:
        raise AssertionError(f"train: checkpoint_best.pt found {best}")

    record = next(r for r in rows if r["split_data"] == "val")
    meta = ["--chord_progression", "-".join(record["chord_progressions"][0]),
            "--rhythm", record["sample_rhythm"]] + [
        x for key in ("bpm", "audio_key", "time_signature", "pitch_range",
                      "num_measures", "inst", "genre", "min_velocity",
                      "max_velocity", "track_role")
        for x in (f"--{key}", str(record[key]))]
    out_dir = root / "generated"
    made = []

    class Recorded(generation.MidiGenerationPipeline):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    torch.cuda.synchronize()
    _build.reset_launches()
    generation.MidiGenerationPipeline = Recorded
    # the decoder names each token that makes no event on stderr: counted
    stderr = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stderr(stderr):
            generate.main(["--checkpoint_dir", str(best[0]), "--output_dir",
                           str(out_dir), "--num_generate",
                           str(CHAIN_GENERATE), "--lenient", "--device",
                           "cuda", *meta], stdout=io.StringIO())
    finally:
        generation.MidiGenerationPipeline = Recorded.__bases__[0]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    run = dict(_build.LAUNCHES)
    totals = made[0].episode_totals()
    graphs = sum(len(episode._graphs)
                 for episode, _ in made[0].episode_cache.values())
    if not (totals["decode_steps"] > 0 and totals["capture_steps"] > 0
            and graphs > 0):
        raise AssertionError(f"generate: no captured episode ran: {totals}, "
                             f"{graphs} graphs")
    missing = [k for k in SERVE_KERNELS if run[k] <= 0]
    if missing:
        raise AssertionError(f"generate: kernels {missing} never launched")
    if run["cache_append"] != totals["decode_steps"] + totals["capture_steps"]:
        raise AssertionError(
            f"generate: cache_append launched {run['cache_append']} times for "
            f"{totals['decode_steps']} replayed and {totals['capture_steps']} "
            "warm-up steps")
    files = sorted(out_dir.rglob("*.mid"))
    if len(files) != CHAIN_GENERATE:
        raise AssertionError(f"generate: {len(files)} .mid files written")
    notes = sum(len(t.notes) for f in files for t in read_midi(f).instruments)
    print(f"[chain] python -m commu_tpu_torch.generate from "
          f"checkpoint_best.pt ({record['id']}'s metadata, "
          f"{record['audio_key']}, {record['bpm']} BPM), --num_generate "
          f"{CHAIN_GENERATE} --lenient, length "
          f"{made[0].inference_cfg.generation_length}: wall_s={wall:.3f} "
          f"(capture_s={totals['capture_s']:.3f}) decode_steps="
          f"{totals['decode_steps']} files={len(files)} notes={notes} "
          f"tokens_without_event={stderr.getvalue().count('OOV: ')} "
          f"launches={run} [{card}]")
    for name, n in run.items():
        launches[name] += n
    return launches


def write_weights(path: Path) -> None:
    """Phase 2: seeded random weights at ModelConfig() in reference .pt
    layout (the JAX package's initializer)."""
    import torch

    from commu_tpu_torch.models import VOCAB_SIZE, ModelConfig, TransformerXL

    model = TransformerXL(VOCAB_SIZE, ModelConfig())
    model.init_parameters(torch.Generator().manual_seed(0))
    torch.save({"model": model.state_dict()}, str(path))


def check_model(pt_path: Path, card: str) -> None:
    """Phase 2b: full-width prefill + decode on the card (kernels) against
    the same model on the CPU (plain versions)."""
    import torch

    from commu_tpu_torch.generation.pipeline import load_model
    from commu_tpu_torch.models import VOCAB_SIZE, ModelConfig, decode

    cfg = ModelConfig(same_length=True)
    tokens = torch.randint(1, VOCAB_SIZE, (2, 14),
                           generator=torch.Generator().manual_seed(1))
    logits = {}
    for dev in ("cuda", "cpu"):
        model = load_model(str(pt_path), cfg, torch.device(dev))
        tok = tokens.to(dev)
        with torch.inference_mode():
            out = [model.logits(model(tok[:, :11]))]
            rel = decode.precompute_rel(model, cfg, 128)
            cache = decode.prefill(model, cfg, tok[:, :11],
                                   decode.init_cache(cfg, 2, 128, device=dev))
            adv = torch.ones(2, dtype=torch.bool, device=dev)
            for j in range(11, 14):
                step, k_self, v_self = decode.decode_step(model, cfg, rel,
                                                          tok[:, j], cache)
                cache = decode.commit(cache, k_self, v_self, adv)
                out.append(step)
        logits[dev] = [x.cpu() for x in out]
    err = 0.0
    for i, (a, b) in enumerate(zip(logits["cuda"], logits["cpu"])):
        err = max(err, _compare(f"model logits {i}", a, b, MODEL_TOL))
    print(f"[model] ModelConfig() prefill + 3 decode steps, card vs CPU: "
          f"max_abs_err={err:.3e} (atol=rtol={MODEL_TOL}) [{card}]")


SERVE_META = {"bpm": 70, "audio_key": "aminor", "time_signature": "4/4",
              "pitch_range": "mid", "inst": "acoustic_piano",
              "genre": "newage", "min_velocity": 60, "max_velocity": 80,
              "track_role": "main_melody", "rhythm": "standard"}
FOUR_BARS = {"num_measures": 4.0, "chord_progression": "-".join(["C"] * 32)}
EIGHT_BARS = {"num_measures": 8.0, "chord_progression": "-".join(
    (["Am"] * 8 + ["F"] * 8 + ["C"] * 8 + ["G"] * 8) * 2)}
# the decode-episode phase: ModelConfig() width, G = 8, a generation length
# whose episode crosses the 256 and 512 cache views (capacity 640)
EPISODE_LENGTH, EPISODE_WIDTH, EPISODE_SEED = 600, 8, 1
BUSY_REPLAYS = 32


def _episode_inputs(temperature: float, width: int):
    from commu_tpu_torch.generation import GenerationInput

    inp = GenerationInput.from_dict({
        **SERVE_META, **EIGHT_BARS, "output_dir": ".", "num_generate": width,
        "top_k": 32, "temperature": temperature})
    return [inp] * width


def _run_timed(episode, chord_cap, batch, metas, seed: int):
    """(tokens, failed, chord_rem, ms, decode steps) of one episode call,
    host clock to the copy of its results."""
    import torch

    from commu_tpu_torch.generation import device_sampler

    gen = torch.Generator(device="cuda").manual_seed(seed)
    steps = episode.steps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = device_sampler.run_episode(episode, chord_cap, batch, metas, gen)
    ms = (time.perf_counter() - t0) * 1e3
    return (*out, ms, episode.steps - steps)


def _same_results(name, eager, graphed) -> None:
    import numpy as np

    if eager[0] != graphed[0]:
        diff = [g for g, (a, b) in enumerate(zip(eager[0], graphed[0]))
                if a != b]
        raise AssertionError(f"{name}: graphed tokens differ from the eager "
                             f"loop's in rows {diff}")
    for what, i in (("failed flags", 1), ("chord_rem", 2)):
        if not np.array_equal(eager[i], graphed[i]):
            raise AssertionError(f"{name}: {what} differ: {eager[i]} against "
                                 f"{graphed[i]}")


def _busy_share(run, replays: int) -> tuple:
    """(share of the host-clock window the card was busy, wall ms, {kernel:
    device ms}, device events) over ``replays`` calls of ``run``, traced."""
    import torch

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(replays):
            run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy, per = _device_busy(prof)
    events = sum(e.device_type == torch.autograd.DeviceType.CUDA
                 for e in prof.events())
    return busy / wall, wall, per, events


APPEND_REPLAYS = 64


def _append_replays(graph, cache, k_self, v_self, advance, replays):
    """ROADMAP C5: replay ``graph`` (``cache_append`` alone) ``replays``
    times over ``cache`` at lengths that move each time (every row's slot
    in range; the cache's lengths and slots restored after), the slots it must
    write set to NaN before each replay and read back after it, and each
    replay under a profiler round of its own -> (replays that wrote every
    such slot of k and v, replays whose round holds the kernel's device
    event)."""
    import torch

    length, (l_dim, g_dim, heads, dh, m_cap) = cache.length, cache.k.shape
    kept = (length.clone(), cache.k.clone(), cache.v.clone())
    written = seen = 0
    for n in range(replays):
        length.copy_((torch.arange(g_dim, device=length.device) * 7 + n)
                     % m_cap)
        pos = length.long()[None, :, None, None, None].expand(
            l_dim, g_dim, heads, dh, 1)
        write = advance[None, :, None, None]
        for buf in (cache.k, cache.v):
            buf.scatter_(4, pos, torch.full_like(buf[..., :1], float("nan")))
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            graph.replay()
            torch.cuda.synchronize()
        seen += any("cache_append" in e.name for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
        written += all(
            bool(torch.where(write, buf.gather(4, pos)[..., 0] == new,
                             True).all())
            for buf, new in ((cache.k, k_self), (cache.v, v_self)))
    for buf, old in zip((length, cache.k, cache.v), kept):
        buf.copy_(old)
    return written, seen


def check_episode_graphs(pt_path: Path, card: str, kernels: dict) -> dict:
    """Phase 3a: the decode episode as captured CUDA graphs against the
    eager loop (``graphs=False``) at ``ModelConfig()`` width, G = 8,
    generation length 600 (views 256, 512, 640), in float32 and bfloat16, at
    temperature 0 and 0.95 from seed 1: the same tokens, failed flags and
    chord_rem; ms per decode step both ways, the capture's seconds, the
    card's busy share over 32 replays (and 32 eager steps), #15's device
    time inside the step graph, and a graph of ``cache_append`` alone that
    must hold its kernel and no copy, and whose every one of
    ``APPEND_REPLAYS`` replays must write the slots it must
    (``_append_replays``, ROADMAP C5).  Returns the launches of the
    episodes' runs."""
    import dataclasses

    import torch

    from commu_tpu_torch.config import get_default_cfg_inference
    from commu_tpu_torch.generation import device_sampler
    from commu_tpu_torch.generation.pipeline import load_model
    from commu_tpu_torch.models import ModelConfig
    from commu_tpu_torch.ops import _build, layout
    from commu_tpu_torch.vocab.meta_codec import encode_meta

    cfg = ModelConfig(same_length=True)
    icfg = dataclasses.replace(get_default_cfg_inference(),
                               generation_length=EPISODE_LENGTH)
    _build.reset_launches()
    runs = []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        model = load_model(str(pt_path), cfg, torch.device("cuda"), dtype)
        for temperature in (0.0, 0.95):
            batch = _episode_inputs(temperature, EPISODE_WIDTH)
            metas = [list(encode_meta(i.midi_meta())) for i in batch]
            eager, chord_cap = device_sampler.cached_episode(
                model, cfg, icfg, batch, graphs=False)
            graphed, _ = device_sampler.cached_episode(model, cfg, icfg, batch)
            ref = _run_timed(eager, chord_cap, batch, metas, EPISODE_SEED)
            first = _run_timed(graphed, chord_cap, batch, metas, EPISODE_SEED)
            before = _build.LAUNCHES["cache_append"]
            again = _run_timed(graphed, chord_cap, batch, metas, EPISODE_SEED)
            tag = f"G={EPISODE_WIDTH} gen_length={EPISODE_LENGTH} {name} " \
                  f"temperature={temperature} seed={EPISODE_SEED}"
            _same_results(f"episode {tag}", ref, first)
            _same_results(f"episode {tag}, second call", ref, again)
            appends = _build.LAUNCHES["cache_append"] - before
            if appends != again[4]:
                raise AssertionError(f"{tag}: cache_append counted {appends} "
                                     f"times over {again[4]} replayed steps")
            print(f"[episode] {tag}: graphed = eager token for token "
                  f"({sum(map(len, ref[0]))} tokens, failed "
                  f"{int(ref[1].sum())}, views {graphed.caps}); ms per decode "
                  f"step eager {ref[3] / ref[4]:.4f}, graphed "
                  f"{again[3] / again[4]:.4f} ({again[4]} steps, "
                  f"{again[3]:.1f} ms a call, prefill included); capture "
                  f"{graphed.capture_seconds:.3f} s ({graphed.capture_steps} "
                  f"warm-up steps); cache_append {appends} launches "
                  f"[{card}]")
            runs.append((name, temperature, model, eager, graphed))
    launches = dict(_build.LAUNCHES)

    # the episodes' buffers are inference tensors
    with torch.inference_mode():
        for name, temperature, model, eager, graphed in runs:
            if temperature == 0.0:
                continue
            view = graphed.caps[1]
            graph, _ = graphed._graphs[view]
            share, wall, per, events = _busy_share(graph.replay,
                                                   BUSY_REPLAYS)
            appends = {k: v for k, v in per.items() if "cache_append" in k}
            append_ms = sum(appends.values()) / BUSY_REPLAYS
            gen = torch.Generator(device="cuda").manual_seed(EPISODE_SEED)
            e_share, e_wall, e_per, e_events = _busy_share(
                lambda: eager.step(gen, view), BUSY_REPLAYS)
            print(f"[episode] busy share over {BUSY_REPLAYS} steps at view "
                  f"{view}, {name}: graphed {share:.3f} of "
                  f"{wall / BUSY_REPLAYS:.4f} ms a step "
                  f"({sum(per.values()) / BUSY_REPLAYS:.4f} ms in "
                  f"{events / BUSY_REPLAYS:.1f} kernels and copies), eager "
                  f"{e_share:.3f} of {e_wall / BUSY_REPLAYS:.4f} ms "
                  f"({sum(e_per.values()) / BUSY_REPLAYS:.4f} ms in "
                  f"{e_events / BUSY_REPLAYS:.1f}); cache_append in the graph "
                  f"{append_ms:.5f} ms a step {sorted(appends)} [{card}]")
            if name == "float32" and "cache_append" in kernels:
                kernels["cache_append"].update(
                    ms_in_step_graph=append_ms, step_graph_busy_share=share,
                    step_graph_ms=wall / BUSY_REPLAYS,
                    step_eager_ms=e_wall / BUSY_REPLAYS)

            # the wrapper adds no copy to the graph: k_self and v_self arrive
            # contiguous in the cache's dtype, as the step's torch.stack gives
            state = graphed.state
            l_dim, g_dim, heads, dh, _ = state.cache.k.shape
            k_self, v_self = (
                torch.randn(l_dim, g_dim, heads, dh, device="cuda")
                .to(state.cache.k.dtype) for _ in range(2))
            advance = torch.ones(g_dim, dtype=torch.bool, device="cuda")
            alone = torch.cuda.CUDAGraph()
            with _build.captured_launches() as recorded:
                with torch.cuda.graph(alone):
                    layout.cache_append(state.cache.k, state.cache.v, k_self,
                                        v_self, state.cache.length, advance)
            written, seen = _append_replays(alone, state.cache, k_self,
                                            v_self, advance, APPEND_REPLAYS)
            _, _, per, _ = _busy_share(alone.replay, BUSY_REPLAYS)
            print(f"[episode] a graph of cache_append alone, {name}: "
                  f"{written} of {APPEND_REPLAYS} replays wrote every slot "
                  f"they must (read back after each, the slots set to NaN "
                  f"before it); a profiler round each: the kernel's device "
                  f"event in {seen} of {APPEND_REPLAYS}; {BUSY_REPLAYS} "
                  f"replays in one trace ran {sorted(per)} [{card}]")
            if written != APPEND_REPLAYS:
                raise AssertionError(
                    f"a graph of cache_append alone ({name}): "
                    f"{APPEND_REPLAYS - written} of {APPEND_REPLAYS} replays "
                    "left a slot unwritten")
            if recorded != {"cache_append": 1} or len(per) != 1 or \
                    "cache_append" not in next(iter(per)):
                raise AssertionError(
                    f"a graph of cache_append alone ({name}) recorded "
                    f"{recorded} and ran {sorted(per)}")
    del runs
    torch.cuda.empty_cache()
    return launches


def serve(pt_path: Path, out_dir: Path, card: str) -> dict:
    """Phase 3b: the real serve loop, in-process, through three server runs
    (--gen_length and --decode_dtype are per process; the first one warms
    the width-1 request's shape before its ready line), then the eager
    yardstick for w8-len1024-f32: the same request through a pipeline whose
    episode steps eagerly (``graphs=False``), and through the captured one
    in the same pipeline, which must give the same sequences.  In a tree
    without captured episodes (a parent's checkout) the requests run as that
    tree runs them and the yardstick is left out."""
    import dataclasses

    import torch

    from commu_tpu_torch import generate
    from commu_tpu_torch.config import get_default_cfg_inference
    from commu_tpu_torch.generation import GenerationInput, device_sampler
    from commu_tpu_torch.generation.pipeline import MidiGenerationPipeline
    from commu_tpu_torch.generation.postprocess import read_midi
    from commu_tpu_torch.ops import _build

    warm = ["--warm", "--num_generate", "1", "--chord_progression",
            FOUR_BARS["chord_progression"], "--num_measures", "4"] + [
        x for key, value in SERVE_META.items()
        for x in (f"--{key}", str(value))]
    runs = [
        (["--gen_length", "1024", *warm],
         [{"request_id": "w1-len1024-f32", "num_generate": 1, **FOUR_BARS},
          {"request_id": "w8-len1024-f32", "num_generate": 8, **EIGHT_BARS}]),
        ([],
         [{"request_id": "w8-len4096-f32", "num_generate": 8, **FOUR_BARS}]),
        (["--gen_length", "1024", "--decode_dtype", "bfloat16"],
         [{"request_id": "w8-len1024-bf16", "num_generate": 8, **EIGHT_BARS}]),
    ]
    _build.reset_launches()
    responses = []
    for flags, requests in runs:
        buf = io.StringIO()
        lines = "".join(json.dumps({**SERVE_META, **r, "seed": 1}) + "\n"
                        for r in requests)
        generate.main(["--checkpoint_dir", str(pt_path), "--output_dir",
                       str(out_dir), "--serve", "--lenient", "--device",
                       "cuda", *flags], stdin=io.StringIO(lines), stdout=buf)
        out = [json.loads(x) for x in buf.getvalue().splitlines()]
        if out[0].get("status") != "ready" or len(out) != len(requests) + 1:
            raise AssertionError(f"serve protocol: {out}")
        if "capture_s" in out[0]:
            print(f"[serve] --warm: ready after a capture of "
                  f"{out[0]['capture_s']:.3f} s [{card}]")
        responses += out[1:]
    launches = dict(_build.LAUNCHES)

    for resp in responses:
        if not resp.get("ok"):
            raise AssertionError(f"request failed: {resp}")
        for path in resp["files"]:
            read_midi(path)
        counts = resp["kernel_launches"]
        missing = [k for k in SERVE_KERNELS if counts[k] <= 0]
        if missing:
            raise AssertionError(f"{resp['request_id']}: kernels {missing} "
                                 "never launched")
        # a tree without captured episodes launches cache_append once a step
        steps = resp.get("decode_steps", counts["cache_append"])
        capture_ms = resp.get("capture_s", 0.0) * 1e3
        if "decode_steps" in resp and counts["cache_append"] != \
                steps + resp["capture_steps"]:
            raise AssertionError(
                f"{resp['request_id']}: cache_append launched "
                f"{counts['cache_append']} times for {steps} replayed steps "
                f"and {resp['capture_steps']} warm-up steps")
        rate = resp["tokens"] / (resp["wall_ms"] / 1e3)
        print(f"[serve] {resp['request_id']}: ok files={len(resp['files'])} "
              f"wall_ms={resp['wall_ms']:.1f} tokens={resp['tokens']} "
              f"generated tokens/s={rate:.1f} decode_steps={steps} "
              f"capture_ms={capture_ms:.1f} ms per decode step (capture "
              f"left out)={(resp['wall_ms'] - capture_ms) / steps:.4f} "
              f"cache_append={counts['cache_append']} [{card}]")
    missing = [k for k in SERVE_KERNELS if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels {missing} never launched on the path")

    if not hasattr(device_sampler, "cached_episode"):
        return launches
    icfg = dataclasses.replace(get_default_cfg_inference(),
                               generation_length=1024)
    pipeline = MidiGenerationPipeline(str(pt_path), inference_cfg=icfg,
                                      device="cuda")
    inp = GenerationInput.from_dict({
        **SERVE_META, **EIGHT_BARS, "output_dir": str(out_dir),
        "num_generate": 8, "top_k": 32, "temperature": 0.95})
    got = {}
    for graphs in (False, True):
        pipeline.episode_cache = {}
        device_sampler.cached_episode(pipeline.model, pipeline.model_cfg, icfg,
                                      [inp] * 8, pipeline.episode_cache,
                                      graphs=graphs)
        totals = pipeline.episode_totals()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        seqs = pipeline.generate_sequences(inp, seed=1, validate=False)
        wall = (time.perf_counter() - t0) * 1e3
        after = pipeline.episode_totals()
        steps = after["decode_steps"] - totals["decode_steps"]
        capture_ms = (after["capture_s"] - totals["capture_s"]) * 1e3
        got[graphs] = seqs
        print(f"[serve] w8-len1024-f32 through the pipeline, "
              f"{'graphed' if graphs else 'eager (graphs=False)'}: wall_ms="
              f"{wall:.1f} decode_steps={steps} capture_ms={capture_ms:.1f} "
              f"ms per decode step (capture left out)="
              f"{(wall - capture_ms) / steps:.4f} generated tokens/s="
              f"{sum(len(s) - 12 for s in seqs) / (wall / 1e3):.1f} [{card}]")
    if got[False] != got[True]:
        raise AssertionError("w8-len1024-f32: the graphed pipeline's "
                             "sequences differ from the eager one's")
    del pipeline
    torch.cuda.empty_cache()
    return launches


# the --profile phase: steps over the trace window of Trainer(profile=True)
PROFILE_STEPS = 16
PROFILE_WINDOW = (4, 10)
# launches a fast-mode train step makes of each kernel, over M = 1024 and
# without memory (the trace must hold each at this count a step)
PROFILE_PER_STEP = {
    "over M = 1024": {
        "project_mem_kv": 6, "rel_attention_mem_fwd[int8]": 6,
        "rel_attention_mem_bwd[int8]": 6, "ffn_block_fwd[bits8]": 6,
        "ffn_block_bwd[bits8]": 6, "nll_fwd": 1, "nll_bwd": 1,
        "embed_grad": 1, "dropout_bdt[bits8]": 4, "ring_write_layer": 7},
    "without memory": {
        "rel_attention_fwd[int8]": 6, "rel_attention_bwd[int8]": 6,
        "ffn_block_fwd[bits8]": 6, "ffn_block_bwd[bits8]": 6, "nll_fwd": 1,
        "nll_bwd": 1, "embed_grad": 1, "dropout_bdt[bits8]": 4},
}
# cuBLAS's and CUTLASS's kernel names (the library products)
LIBRARY_PRODUCT = r"gemm|gemv|cutlass|cublas|xmma|nvjet|splitK|Kernel2"


def _source_kernels() -> set:
    """The ``__global__`` function names of ``commu_tpu_torch/csrc``."""
    import re

    names = set()
    for src in sorted((Path(__file__).resolve().parent / "commu_tpu_torch"
                       / "csrc").glob("*.cu*")):
        names.update(re.findall(r"__global__[^;{]*?\b(\w+_kernel)\s*\(",
                                src.read_text(), flags=re.S))
    return names


def _short_kernel(name: str) -> str:
    """A PyTorch kernel's functor or kernel name out of its demangled
    template (``direct_copy_kernel_cuda``, ``CUDAFunctor_add``, ...), or
    the name's first words."""
    import re

    if name.startswith(("Memcpy", "Memset")):
        return " ".join(name.split()[:2])
    generic = {"elementwise_kernel", "vectorized_elementwise_kernel",
               "unrolled_elementwise_kernel", "gpu_kernel_impl_nocast",
               "gpu_kernel_impl", "TensorIteratorBase"}
    found = []
    for t in re.findall(r"[A-Za-z_]\w*", name):
        if t not in generic and t not in found and re.search(
                r"Functor|kernel|Kernel|Forward|Backward|cunn|Ops?$|Norm", t):
            found.append(t)
    return " ".join(found[:2]) if found else name.split("(")[0][:60]


def _trace_split(path: Path, steps: int) -> dict:
    """A ``Trainer(profile=True)`` Chrome trace, split: every device kernel,
    copy and fill is attributed through its launch's correlation id to the
    innermost range around the launch on its CPU thread, among the
    ``commu::<kernel>`` ranges (``ops._build.span``: one per wrapper launch),
    ``commu::clip`` and Adam's ``Optimizer.step``; the rest go by name to
    the library products (``LIBRARY_PRODUCT``) or stay "other: <kernel> <-
    <the outermost CPU op around its launch>".
    Returns {"groups": {group: device ms a step}, "launches": {kernel:
    ranges a step}, "window_ms", "busy_ms", "idle_ms" (the span from the
    first to the last device event, the union of device intervals, the
    difference; a step each), "device_events", "hand_written" (device
    events whose name is a kernel of ``csrc``)}."""
    import bisect
    import re

    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    ranges = {}
    launches = {}
    for e in events:
        name = e.get("name", "")
        if e.get("ph") != "X" or e.get("cat") != "user_annotation":
            continue
        if name.startswith("commu::") or name.startswith("Optimizer.step"):
            ranges.setdefault(e["tid"], []).append(
                (e["ts"], e["ts"] + e["dur"], name))
            if name.startswith("commu::") and name != "commu::clip":
                kernel = name[len("commu::"):]
                launches[kernel] = launches.get(kernel, 0) + 1
    for spans in ranges.values():
        spans.sort()
    starts = {tid: [s[0] for s in spans] for tid, spans in ranges.items()}

    def owner(tid, ts):
        spans = ranges.get(tid, [])
        for i in range(bisect.bisect_right(starts.get(tid, []), ts) - 1,
                       -1, -1):
            if spans[i][1] >= ts:
                return spans[i][2]
        return None

    # the outermost CPU op of each thread around a time (top-level ops)
    tops = {}
    for e in sorted((e for e in events if e.get("ph") == "X"
                     and e.get("cat") == "cpu_op"), key=lambda e: e["ts"]):
        top = tops.setdefault(e["tid"], [])
        if not top or e["ts"] >= top[-1][1]:
            top.append((e["ts"], e["ts"] + e["dur"], e["name"]))
    top_starts = {tid: [t[0] for t in top] for tid, top in tops.items()}

    def outer_op(tid, ts):
        i = bisect.bisect_right(top_starts.get(tid, []), ts) - 1
        if i >= 0 and tops[tid][i][1] >= ts:
            return tops[tid][i][2]
        return "no op"

    by_corr, op_by_corr = {}, {}
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and \
                "correlation" in e.get("args", {}):
            corr = e["args"]["correlation"]
            found = owner(e["tid"], e["ts"])
            if found is not None:
                by_corr[corr] = found
            op_by_corr[corr] = outer_op(e["tid"], e["ts"])
    ours = _source_kernels()
    mine = re.compile(r"(?<!\w)(" + "|".join(sorted(ours)) + r")(?!\w)")
    groups, spans, hand_written, device = {}, [], 0, 0
    for e in events:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset") or \
                e.get("ph") != "X":
            continue
        device += 1
        spans.append((e["ts"], e["ts"] + e["dur"]))
        name = e.get("name", "")
        hand_written += bool(mine.search(name))
        corr = e.get("args", {}).get("correlation")
        found = by_corr.get(corr)
        if found == "commu::clip":
            group = "clip (norms, scale)"
        elif found is not None and found.startswith("Optimizer.step"):
            group = "optimizer (Adam)"
        elif found is not None:
            group = "kernel " + found[len("commu::"):]
        elif re.search(LIBRARY_PRODUCT, name):
            group = "library products (cuBLAS/CUTLASS)"
        else:
            group = (f"other: {_short_kernel(name)} <- "
                     f"{op_by_corr.get(corr, 'no launch')[:70]}")
        groups[group] = groups.get(group, 0.0) + e["dur"] / 1e3 / steps
    busy, end = 0.0, float("-inf")
    for start, stop in sorted(spans):
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    window = (max(s[1] for s in spans) - min(s[0] for s in spans)) \
        if spans else 0.0
    return {"groups": groups,
            "launches": {k: v / steps for k, v in launches.items()},
            "window_ms": window / 1e3 / steps, "busy_ms": busy / 1e3 / steps,
            "idle_ms": (window - busy) / 1e3 / steps,
            "device_events": device, "hand_written": hand_written}


def _step_ms(record, steps) -> float:
    """Mean host-clock ms of the given 0-based steps of a ``train`` record
    (step i: from the sync after step i - 1 to the sync after step i)."""
    return 1e3 * sum(record[i][0] - record[i - 1][0] for i in steps) / \
        len(steps)


def _profile_trace(work_dir: Path) -> Path:
    found = sorted(work_dir.glob("*/*/profile/trace_steps_*.json"))
    if len(found) != 1:
        raise AssertionError(f"{work_dir}: expected one trace under "
                             f"<run>/profile/, found {found}")
    return found[0]


def profile_split(data_dir: Path, work_dir: Path, card: str) -> dict:
    """``[profile]``: ``python -m commu_tpu_torch.train --profile`` in the
    fast mode, f32, at ``TrainConfig()`` and ``ModelConfig()`` (dropout
    0.1), ``PROFILE_STEPS`` steps over M = 1024 and without memory.  Each
    run must leave one trace of steps 4-10 in ``<work_dir>/profile/``
    holding every kernel of its step at its launches a step
    (``PROFILE_PER_STEP``), each with device time.  Prints the device ms a
    step of each hand-written kernel, the library products, Adam, the
    clip, the ten largest other kernels and copies by name, the card's busy
    and idle ms a step over the traced device span, and the step's
    host-clock ms with the profiler on (steps 5-9) and off (steps 2-3 and
    11-15).  Returns the launches per kernel over both runs."""
    from commu_tpu_torch.ops import _build

    total = {name: 0 for name in _build.LAUNCHES}
    steps = PROFILE_WINDOW[1] - PROFILE_WINDOW[0]
    for label, flags, wanted in (
            ("over M = 1024", (), FAST_TRAIN_KERNELS),
            ("without memory", NO_MEMORY, FAST_CAPACITY0_KERNELS)):
        per_step = PROFILE_PER_STEP[label]
        records = {}
        run_dir = work_dir / label.replace(" ", "_").replace("=", "")
        launches, _ = train(
            data_dir, run_dir, card, True, ("float32",), PROFILE_STEPS,
            ("--profile",) + tuple(flags), wanted, FAST_UNWANTED, None,
            {k: v for k, v in per_step.items() if "bwd" in k}, False,
            records=records)
        for name, n in launches.items():
            total[name] += n
        trace = _profile_trace(run_dir)
        split = _trace_split(trace, steps)
        record = records["float32"]
        on = _step_ms(record, range(PROFILE_WINDOW[0] + 1, PROFILE_WINDOW[1]))
        off = _step_ms(record, [2, 3] + list(range(PROFILE_WINDOW[1] + 1,
                                                   PROFILE_STEPS)))
        print(f"[profile] fast mode f32 {label}: {trace.name} "
              f"({trace.stat().st_size / 2 ** 20:.1f} MiB, "
              f"{split['device_events']} device events in {steps} steps); "
              f"step ms with the profiler on {on:.2f} (steps 5-9), off "
              f"{off:.2f} (steps 2-3, 11-15) [{card}]")
        print(f"[profile]   device span {split['window_ms']:.3f} ms a step, "
              f"busy {split['busy_ms']:.3f}, idle gaps {split['idle_ms']:.3f}"
              f" ({split['idle_ms'] / max(split['window_ms'], 1e-9):.4f} of "
              f"the span) [{card}]")
        groups = split["groups"]
        kernels = sorted((k for k in groups if k.startswith("kernel ")),
                         key=lambda k: -groups[k])
        others = sorted((k for k in groups if k.startswith("other: ")),
                        key=lambda k: -groups[k])
        named = [k for k in ("library products (cuBLAS/CUTLASS)",
                             "optimizer (Adam)", "clip (norms, scale)")
                 if k in groups]
        for key in kernels + named:
            launch = split["launches"].get(key[len("kernel "):])
            print(f"[profile]   {groups[key]:9.4f} ms a step  {key}"
                  + (f" x{launch:g}" if launch is not None else ""))
        print(f"[profile]   {sum(groups[k] for k in others):9.4f} ms a step "
              f"in {len(others)} other kernels and copies; the ten largest:")
        for key in others[:10]:
            print(f"[profile]   {groups[key]:9.4f} ms a step  {key}")
        print(f"[profile]   {sum(groups.values()):9.4f} ms a step of device "
              f"time in all [{card}]")
        errors = []
        for name, want in per_step.items():
            got = split["launches"].get(name, 0)
            if got != want:
                errors.append(f"{name} {got:g} a step in the trace, "
                              f"expected {want}")
            elif groups.get(f"kernel {name}", 0.0) <= 0.0:
                errors.append(f"{name}: no device time attributed")
        stray = sorted(set(split["launches"]) - set(per_step))
        if stray:
            errors.append(f"kernels {stray} in the trace")
        if errors:
            raise AssertionError(f"profile {label}: " + "; ".join(errors))
    return total


def host_sampler_phase(pt_path: Path, out_dir: Path, card: str) -> dict:
    """``[host]``: the host-parity loop on the seeded weights at
    ``ModelConfig()`` width, f32: a width-1 request (8 bars) at generation
    length 1024 through ``MidiGenerationPipeline(sampler="host")`` and
    through the device sampler at temperature 0 (the tokens must be
    equal; the host run must launch #1 and #7 six times each in its prefill
    and #15 at every committed step, every forward but the first sampling
    one), then ``python -m commu_tpu_torch.generate --sampler host
    --lenient --gen_length 1024`` in-process at temperature 0.95 with a
    seed, whose ``.mid`` must parse back; then ``check_gumbel``.  Prints
    wall ms, ms per decode step and the launches.  Returns the launches per
    kernel."""
    import dataclasses

    import torch

    from commu_tpu_torch import generate
    from commu_tpu_torch.config import get_default_cfg_inference
    from commu_tpu_torch.generation import GenerationInput
    from commu_tpu_torch.generation.pipeline import MidiGenerationPipeline
    from commu_tpu_torch.generation.postprocess import read_midi
    from commu_tpu_torch.ops import _build

    total = {name: 0 for name in _build.LAUNCHES}
    icfg = dataclasses.replace(get_default_cfg_inference(),
                               generation_length=1024)
    inp = GenerationInput.from_dict({
        **SERVE_META, **EIGHT_BARS, "output_dir": str(out_dir),
        "num_generate": 1, "top_k": 32, "temperature": 0.0})
    seqs = {}
    for sampler in ("host", "jit"):
        pipeline = MidiGenerationPipeline(str(pt_path), inference_cfg=icfg,
                                          device="cuda", sampler=sampler)
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        seqs[sampler] = pipeline.generate_sequences(inp, seed=0,
                                                    validate=False)
        wall = (time.perf_counter() - t0) * 1e3
        run = dict(_build.LAUNCHES)
        totals = pipeline.episode_totals()
        steps, capture_ms = totals["decode_steps"], totals["capture_s"] * 1e3
        for name, n in run.items():
            total[name] += n
        print(f"[host] w1-len1024-f32 temperature 0, sampler={sampler}: "
              f"wall_ms={wall:.1f} capture_ms={capture_ms:.1f} decode_steps="
              f"{steps} ms per decode step (capture left out)="
              f"{(wall - capture_ms) / steps:.4f} "
              f"tokens={len(seqs[sampler][0]) - 12} "
              f"rel_attention_fwd={run['rel_attention_fwd']} "
              f"ffn_block_fwd={run['ffn_block_fwd']} "
              f"cache_append={run['cache_append']} [{card}]")
        if sampler == "host":
            want = {"rel_attention_fwd": 6, "ffn_block_fwd": 6,
                    "cache_append": steps - 1}
            got = {k: run[k] for k in want}
            if got != want or sum(run.values()) != sum(want.values()):
                raise AssertionError(f"host sampler launches {run}, "
                                     f"expected {want}")
        del pipeline
    if seqs["host"] != seqs["jit"]:
        first = next((i for i, (a, b) in enumerate(zip(
            seqs["host"][0], seqs["jit"][0])) if a != b),
            min(len(seqs["host"][0]), len(seqs["jit"][0])))
        raise AssertionError(
            f"host and device samplers differ at temperature 0 from token "
            f"{first}: lengths {len(seqs['host'][0])} and "
            f"{len(seqs['jit'][0])}")
    print(f"[host] temperature 0: the host loop's {len(seqs['host'][0])} "
          f"tokens equal the device sampler's [{card}]")

    meta = [x for key, value in SERVE_META.items()
            for x in (f"--{key}", str(value))]
    _build.reset_launches()
    t0 = time.perf_counter()
    buf = io.StringIO()
    generate.main(["--checkpoint_dir", str(pt_path), "--output_dir",
                   str(out_dir / "host"), "--sampler", "host", "--lenient",
                   "--gen_length", "1024", "--temperature", "0.95",
                   "--seed", "3", "--num_generate", "1", "--num_measures",
                   "8", "--chord_progression",
                   EIGHT_BARS["chord_progression"], *meta], stdout=buf)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    run = dict(_build.LAUNCHES)
    files = sorted((out_dir / "host").rglob("*.mid"))
    if len(files) != 1:
        raise AssertionError(f"generate --sampler host wrote {files}")
    midi = read_midi(str(files[0]))
    notes = sum(len(i.notes) for i in midi.instruments)
    print(f"[host] python -m commu_tpu_torch.generate --sampler host "
          f"temperature 0.95 seed 3: wall_ms={wall:.1f} (model load "
          f"included) {files[0].name} parses back, {notes} notes; "
          f"rel_attention_fwd={run['rel_attention_fwd']} "
          f"ffn_block_fwd={run['ffn_block_fwd']} "
          f"cache_append={run['cache_append']} [{card}]")
    if run["rel_attention_fwd"] != 6 or run["cache_append"] <= 0:
        raise AssertionError(f"generate --sampler host launches {run}")
    for name, n in run.items():
        total[name] += n
    for name, n in check_gumbel(pt_path, card).items():
        total[name] += n
    return total


def check_gumbel(pt_path: Path, card: str) -> dict:
    """``[gumbel]``: ``forward_generate_gumbel`` over a ring of 256 slots,
    two windows of 2 x 128 tokens at ``ModelConfig()`` width, f32, on the
    card and on the CPU (plain versions) from the seeded weights and one
    shared uniform draw: the one-hot samples must be equal and the memory
    within ``MODEL_TOL``.  Returns the card's launches."""
    import numpy as np
    import torch

    from commu_tpu_torch.models import (VOCAB_SIZE, ModelConfig,
                                        TransformerXL, forward_generate_gumbel,
                                        init_memory, load_reference_pt)
    from commu_tpu_torch.ops import _build

    rng = np.random.default_rng(16)
    tokens = [torch.from_numpy(rng.integers(1, VOCAB_SIZE, size=(2, 128)))
              for _ in range(2)]
    noise = [torch.from_numpy(rng.uniform(size=(2, 128, VOCAB_SIZE))
                              .astype(np.float32)) for _ in range(2)]
    out = {}
    for dev in ("cuda", "cpu"):
        model = TransformerXL(VOCAB_SIZE, ModelConfig())
        model.load_state_dict(load_reference_pt(pt_path), strict=False)
        model = model.to(dev).eval()
        memory = init_memory(6, 2, 256, 500, block_len=128, device=dev)
        _build.reset_launches()
        samples = []
        with torch.inference_mode():
            for tok, u in zip(tokens, noise):
                sample, memory = forward_generate_gumbel(
                    model, tok.to(dev), memory, 0.95, u_noise=u.to(dev))
                samples.append(sample.argmax(-1).cpu())
        out[dev] = (torch.stack(samples), memory.hidden.float().cpu(),
                    dict(_build.LAUNCHES))
    same = bool((out["cuda"][0] == out["cpu"][0]).all())
    err = float((out["cuda"][1] - out["cpu"][1]).abs().max())
    scale = float(out["cpu"][1].abs().max())
    print(f"[gumbel] forward_generate_gumbel ModelConfig() f32, 2 windows of "
          f"2 x 128 over a 256-slot ring, card vs CPU: one-hot samples "
          f"{'equal' if same else 'DIFFER'}, memory max abs err {err:.3e} "
          f"(max |x| {scale:.3f}, rtol {MODEL_TOL}) [{card}]")
    if not same or err > MODEL_TOL * scale:
        raise AssertionError("forward_generate_gumbel: card and CPU differ")
    return out["cuda"][2]


def unfused_phase(data_dir: Path, work_dir: Path, card: str) -> dict:
    """``[unfused]``: the train CLI on the unfused path (``--set
    model.attn_impl=xla``) at ``TrainConfig()`` and ``ModelConfig()`` width
    at dropout 0: 11 steps in f32 with ``--profile`` and 4 in bf16, beside
    the kernel path's 4 ``--precise_bd`` steps in each dtype from the same
    weights and batches: step 0's ``nll_sum`` and ``grad_norm`` must agree
    within rtol ``MODEL_TOL``.  The f32 run's trace must hold no launch of
    the sixteen kernels and no device event of a ``csrc`` kernel, and no
    run may count a launch.  Then ``Trainer.evaluate("valid")`` at
    ``EvaluateConfig()`` on both paths from the same seeded weights, f32
    and bf16: the val NLL within rtol ``MODEL_TOL``.  Then 4 f32 steps with
    ``--set model.clamp_len=64`` at dropout 0.1: finite losses.  Prints ms a
    step and peak memory (the ``[train]`` lines).  Returns the launches
    per kernel (all 0)."""
    import math

    import torch

    from commu_tpu_torch.config import ModelConfig, TrainingConfig
    from commu_tpu_torch.ops import _build
    from commu_tpu_torch.training import Trainer

    every = tuple(_build.LAUNCHES)
    unfused = ("--set", "model.attn_impl=xla")
    errors = []
    kernel_rec, unfused_rec = {}, {}
    train(data_dir, work_dir / "kernel", card, False,
          ("float32", "bfloat16"), 4, records=kernel_rec)
    launches, _ = train(data_dir, work_dir / "unfused", card, False,
                        ("float32",), 11, unfused + ("--profile",), (),
                        every, records=unfused_rec)
    more, _ = train(data_dir, work_dir / "unfused_bf16", card, False,
                    ("bfloat16",), 4, unfused, (), every,
                    records=unfused_rec)
    for name, n in more.items():
        launches[name] += n
    for dtype in ("float32", "bfloat16"):
        (_, k_nll, _, k_norm), (_, u_nll, _, u_norm) = \
            kernel_rec[dtype][0], unfused_rec[dtype][0]
        rel = (abs(u_nll - k_nll) / abs(k_nll),
               abs(u_norm - k_norm) / abs(k_norm))
        print(f"[unfused] step 0 {dtype}, unfused vs kernel path "
              f"(--precise_bd): nll_sum {u_nll!r} vs {k_nll!r} "
              f"(rel {rel[0]:.3e}), grad_norm {u_norm!r} vs {k_norm!r} "
              f"(rel {rel[1]:.3e}), rtol {MODEL_TOL} [{card}]")
        if max(rel) > MODEL_TOL:
            errors.append(f"step 0 {dtype}: rel diffs {rel}")
        rec = unfused_rec[dtype]
        print(f"[unfused] {dtype}: ms/step {_step_ms(rec, [2, 3]):.1f} "
              f"against the kernel path's exact "
              f"{_step_ms(kernel_rec[dtype], [2, 3]):.1f} (steps 3-4, no "
              f"profiler) [{card}]")
    split = _trace_split(_profile_trace(work_dir / "unfused"),
                         PROFILE_WINDOW[1] - PROFILE_WINDOW[0])
    top = sorted(split["groups"].items(), key=lambda x: -x[1])[:6]
    print(f"[unfused] f32 traced steps 4-10: {split['device_events']} device "
          f"events, {sum(split['launches'].values()):g} launches of the "
          f"sixteen kernels a step, {split['hand_written']} device events of "
          f"a csrc kernel; device {sum(split['groups'].values()):.3f} ms a "
          f"step, busy {split['busy_ms']:.3f}, idle gaps "
          f"{split['idle_ms']:.3f} [{card}]")
    for key, ms in top:
        print(f"[unfused]   {ms:9.4f} ms a step  {key}")
    if split["launches"] or split["hand_written"] or \
            not split["device_events"]:
        errors.append(f"the unfused trace: launches {split['launches']}, "
                      f"{split['hand_written']} csrc device events, "
                      f"{split['device_events']} device events")

    for dtype in (torch.float32, torch.bfloat16):
        nll = {}
        for impl in ("xla", "pallas"):
            cfg = TrainingConfig(model=ModelConfig(attn_impl=impl))
            trainer = Trainer(str(data_dir), cfg, device="cuda",
                              model_dtype=dtype)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tokens, nll_sum = trainer.evaluate("valid")
            torch.cuda.synchronize()
            nll[impl] = (nll_sum / tokens, time.perf_counter() - t0, tokens)
            del trainer
        rel = abs(nll["xla"][0] - nll["pallas"][0]) / abs(nll["pallas"][0])
        print(f"[unfused] Trainer.evaluate EvaluateConfig() {dtype}: val nll "
              f"{nll['xla'][0]!r} (unfused, {nll['xla'][1]:.3f} s) vs "
              f"{nll['pallas'][0]!r} (kernel path, {nll['pallas'][1]:.3f} s), "
              f"rel {rel:.3e}, tokens {nll['xla'][2]} (rtol {MODEL_TOL}) "
              f"[{card}]")
        if rel > MODEL_TOL or nll["xla"][2] != nll["pallas"][2]:
            errors.append(f"val nll {dtype}: {nll}")

    clamp_rec = {}
    more, _ = train(data_dir, work_dir / "clamp", card, True, ("float32",),
                    4, ("--set", "model.clamp_len=64"), (), every,
                    records=clamp_rec)
    for name, n in more.items():
        launches[name] += n
    losses = [r[1] / r[2] for r in clamp_rec["float32"]]
    print(f"[unfused] clamp_len=64 dropout 0.1 f32: per-token nll by step "
          f"{', '.join(f'{x:.4f}' for x in losses)} [{card}]")
    if not all(math.isfinite(x) for x in losses):
        errors.append(f"clamp_len=64 losses {losses}")
    if any(launches.values()):
        errors.append(f"the unfused runs launched {launches}")
    if errors:
        raise AssertionError("unfused: " + "; ".join(errors))
    return launches


def _compare_int8_rows(name, ours, ref, tol) -> float:
    """An int8 forward's score plane S [B, H, T, K] against its twin's, the
    masked entries set aside: one phi_q element on a rounding tie moves a
    whole row of S, so at most 1 in 100 rows (or 4) may hold an element
    beyond tol x (max|ref| + |ref|), and none is beyond max(20 tol, 5e-3) x
    max|ref| (``INT8_ROWS_TOL``).  Returns the max abs error."""
    import torch

    torch.cuda.synchronize()
    live = ref > -1e30
    if not torch.equal(live, ours > -1e30):
        raise AssertionError(f"{name}: the masked scores differ")
    ref = torch.where(live, ref.float(), 0.0)
    err = (torch.where(live, ours.float(), 0.0) - ref).abs()
    top = float(ref.abs().max().clamp(min=1e-30))
    rows = (err > tol * (top + ref.abs())).any(dim=-1)
    far = max(20 * tol, 5e-3)
    if int(rows.sum()) > max(1e-2 * rows.numel(), 4) or \
            float(err.max()) > far * top:
        raise AssertionError(
            f"{name}: {int(rows.sum())} of {rows.numel()} rows beyond {tol} x "
            f"(max|ref| + |ref|), max abs err {float(err.max()):.3e} "
            f"(max|ref| {top:.3e})")
    return float(err.max())


def _compare_int8_position(name, ours, ref, exact, tol,
                           far_floor=5e-3) -> float:
    """An int8 backward's position gradient (dq, dW_r, d r_r_bias) against
    its int8 twin, ``exact`` the exact twin's: one ds_q rounding tie that
    kernel and twin break apart moves a whole row of dphi, and so a head's
    plane of dW_r (at dh 256 a quarter of the output), so a count of
    elements says little.  Held as the ``cuda`` tests hold it: the mean
    distance to the int8 twin at most a tenth of the int8 twin's mean
    distance to the exact one, and none beyond max(20 tol, ``far_floor``)
    x max|ref| (``INT8_POSITION_TOL``).  The gradients that the int8 dq or
    dk quantise take the same rule with ``far_floor`` 2e-2
    (``INT8_GRADS_TOL``): an element of [ds | du] (of ds's column) on a tie
    of its quantiser moves a whole column of dq (dk) by one step times a
    row of [k | W_r] (qw), which reached 8.7e-3 of max|dq| at 1536 / 12.
    Returns the max abs error."""
    import torch

    torch.cuda.synchronize()
    ref, exact = ref.float(), exact.float()
    gap = float((ref - exact).abs().mean())
    err = (ours.float() - ref).abs()
    top = float(ref.abs().max().clamp(min=1e-30))
    if not torch.isfinite(ours.float()).all() or gap <= 0.0 \
            or float(err.mean()) > 0.1 * gap \
            or float(err.max()) > max(20 * tol, far_floor) * top:
        raise AssertionError(
            f"{name}: mean abs err {float(err.mean()):.3e} against the int8 "
            f"twin, whose mean distance to the exact twin is {gap:.3e}; max "
            f"abs err {float(err.max()):.3e} (max|ref| {top:.3e})")
    return float(err.max())


INT8_GRADS_TOL = ("the quantised gradients' mean error at most a tenth of "
                  "the twin's mean distance to the twin without the int8 "
                  "products, none beyond {far} x max|ref|")
INT8_POSITION_TOL = ("the position gradients' mean error at most a tenth of "
                     "the int8 twin's mean distance to the exact twin, none "
                     "beyond {far} x max|ref|")
INT8_ROWS_TOL = ("S: all but 1e-2 of the rows within {tol} x (max|ref| + "
                 "|ref|), none beyond {far} x max|ref|; out, lse: " + INT8_TOL)


def _dw_mem_f64(bwd, mode):
    """dWk and dWv of the memory backward's operands ``bwd``, summed in f64
    over the twin's dk and dv (rounded to the compute dtype, as the twin
    rounds them): the reference for sums of B x M terms, where the f32
    twin's own order errs as much as the kernel's."""
    import torch

    from commu_tpu_torch.ops import fused_attention as fa

    (q, rwbs, rrbs, k_mem, k_win, v_mem, v_win, mem, layer, w_r, trig_a, psi,
     s_res, lse, out, dout, scale) = bwd
    _, dk, dv, *_ = fa._attention_bwd_plain(
        q, rwbs, rrbs, fa._ring_keys(k_mem, k_win), fa._ring_keys(v_mem, v_win),
        w_r, trig_a, psi, s_res, lse, out, dout, scale, **mode)
    b, m_cap = mem.shape[2], mem.shape[1] * mem.shape[4]
    ring = mem[layer].permute(1, 2, 0, 3).reshape(b, mem.shape[3], m_cap)
    ring = ring.double()
    return [torch.einsum("bhcj,bej->hce",
                         x[..., :m_cap].to(q.dtype).double(), ring).float()
            for x in (dk, dv)]


# --sums: csrc/sums.cu's entry points (the shared deep sums alone) at the
# depths of the main path's products and weight gradients: (name, entry,
# shape[, terms]); tile_product (Kp, Mm, Tp, B), the batch sums (M, N, rows,
# len); ``terms``: the depth values that are not zero (the rest of A's
# depth zero), in f32 only: one mma step (8 terms) and one staged chunk
# (16 in the tile, 32 in the copy sum), whose truncation no promotion
# outside the mma touches
SUM_CASES = (
    ("#5's projection", "kv_product", (512, 1024, 128, 2048)),
    ("the mma.sync tile at #5's depth", "tile_product", (512, 1024, 128, 2048)),
    ("#8's da = W1 dh1_c", "tile_product", (1024, 512, 128, 256)),
    ("#9's depth 16,384", "tile_product", (16384, 256, 128, 2)),
    ("one mma step (depth 8)", "tile_product", (16, 1024, 128, 64), 8),
    ("one chunk (depth 16)", "tile_product", (16, 1024, 128, 64), 16),
    ("#8's dW1", "sum_outer_copy", (500, 1000, 256, 128)),
    ("#8's dW1", "sum_outer_mma", (500, 1000, 256, 128)),
    ("#4's dWk", "sum_outer_wg", (500, 500, 256, 1024)),
    ("#4's dWk at units 1536", "sum_outer_wg", (1536, 1536, 256, 1024)),
    ("the copy sum at #4's dWk", "sum_outer_copy", (500, 500, 256, 1024)),
    ("one mma step (depth 8)", "sum_outer_copy", (512, 512, 1, 32), 8),
    ("one chunk (depth 32)", "sum_outer_copy", (512, 512, 1, 32), 32),
    ("one wgmma step (depth 8)", "kv_product", (8, 1024, 128, 64), 8),
    ("one wgmma step (depth 8)", "sum_outer_wg", (512, 512, 1, 32), 8),
    ("one chunk (depth 32)", "sum_outer_wg", (512, 512, 1, 32), 32))


def sums_check(card: str) -> None:
    """``[sums]``: each of ``SUM_CASES`` in f32 and bf16 from seeded normal
    operands against the same sum in f64: max |err| / max |ref|, the mean
    error and the mean error toward each reference value's sign (a sum that
    loses bits toward zero errs against it), both over the mean |err|, and
    the entry's ms.  A measurement; ``csrc/sums.cu``'s entry points as
    this commit has them (the tile's takes its second level's
    workspace)."""
    import ctypes

    import torch

    from commu_tpu_torch.ops import _build

    lib = _build.library()
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    has_wg = hasattr(lib, "commu_kv_product")  # the warpgroup product
    for name in ("sum_outer_copy", "sum_outer_mma") + (
            ("sum_outer_wg",) if has_wg else ()):
        wide = name == "sum_outer_wg"  # its parts after the shape
        entry = getattr(lib, f"commu_{name}")
        entry.argtypes = [i32] + [ptr] * 4 + [i32] * (4 + wide) + [ptr]
        entry.restype = i32
        getattr(lib, f"commu_{name}_workspace").argtypes = [i32] * (4 + wide)
        getattr(lib, f"commu_{name}_workspace").restype = ctypes.c_longlong
    lib.commu_tile_product.argtypes = [i32] + [ptr] * 4 + [i32] * 4 + [ptr]
    lib.commu_tile_product.restype = i32
    lib.commu_tile_product_workspace.argtypes = [i32] * 5
    lib.commu_tile_product_workspace.restype = ctypes.c_longlong
    if has_wg:
        lib.commu_kv_product.argtypes = [i32] + [ptr] * 4 + [i32] * 4 + [ptr]
        lib.commu_kv_product.restype = i32
        lib.commu_kv_product_workspace.argtypes = [i32] * 3
        lib.commu_kv_product_workspace.restype = ctypes.c_longlong
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(18)
    for dtype in (torch.float32, torch.bfloat16):
        code = 0 if dtype == torch.float32 else 1
        for what, entry, shape, *terms in SUM_CASES:
            if terms and dtype != torch.float32:
                continue  # the f32 mma's own truncation (bf16: 32-deep chunks)
            if entry in ("kv_product", "sum_outer_wg") and not has_wg:
                continue  # a tree before the warpgroup product
            if entry in ("tile_product", "kv_product"):
                kp, mm, tp, b = shape
                a = torch.randn(kp, mm, generator=gen, device=dev).to(dtype)
                x = torch.randn(b, kp, tp, generator=gen, device=dev).to(dtype)
                if terms:
                    a[terms[0]:] = 0
                out = torch.empty(b, mm, tp, device=dev)
                scratch = torch.empty(max(1, int(
                    lib.commu_tile_product_workspace(code, *shape)
                    if entry == "tile_product" else
                    lib.commu_kv_product_workspace(code, kp, mm))),
                    dtype=torch.uint8, device=dev)
                args = (code, a.data_ptr(), x.data_ptr(), out.data_ptr(),
                        scratch.data_ptr(), *shape)
                ref = (torch.einsum("km,bkt->bmt", a.double(), x.double())
                       if b * mm * tp <= 1 << 23 else None)
            else:
                m, n, rows, length = shape
                a, x = (torch.randn(rows, k, length, generator=gen,
                                    device=dev).to(dtype) for k in (m, n))
                if terms:
                    a[..., terms[0]:] = 0
                parts = ()
                if entry == "sum_outer_wg":
                    a = a.float()  # its A is f32, rounded to bf16 on load
                    parts = (1,)
                out = torch.empty(m, n, device=dev)
                scratch = torch.empty(max(1, int(getattr(
                    lib, f"commu_{entry}_workspace")(*shape, *parts))),
                    dtype=torch.uint8, device=dev)
                args = (code, a.data_ptr(), x.data_ptr(), out.data_ptr(),
                        scratch.data_ptr(), *shape, *parts)
                ref = torch.einsum("bmt,bnt->mn", a.double(), x.double())

            def run(fn=getattr(lib, f"commu_{entry}"), args=args):
                err = fn(*args, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{entry}: CUDA error {err}")
            ms = _cuda_ms(run, 20, 2)
            line = f"[sums] {what} ({entry} {shape}) {dtype}: {ms:.4f} ms"
            if ref is not None:
                run()
                torch.cuda.synchronize()
                err = out.double() - ref
                spread = float(err.abs().mean())
                top = float(ref.abs().max())
                toward = float((err * ref.sign()).mean())
                line += (f", max|err|/max|ref| "
                         f"{float(err.abs().max()) / top:.3e}, mean err "
                         f"{float(err.mean()) / spread:+.3f}, toward zero "
                         f"{toward / spread:+.3f} of mean|err|")
            print(line + f" [{card}]")
            del a, x, out, ref
        torch.cuda.empty_cache()


# the kernels that #1's, #2's and #6's sources may hold: the narrow
# tensor-core body's and the wide one's (csrc/rel_attention_fwd_mma.cuh,
# rel_attention_fwd_wide.cuh), and #6's weight copies; no FMA kernel is left
FORWARD_KERNELS = {
    "rel_attention_fwd.cu": ("rel_attention_fwd_mma_kernel",
                             "rel_attention_fwd_wide_kernel"),
    "rel_attention_mem_fwd.cu": ("rel_attention_mem_fwd_kernel",
                                 "rel_attention_mem_fwd_wide_kernel"),
    "rel_attention_proj_fwd.cu": ("proj_weights_kernel",
                                  "rel_attention_proj_fwd_mma_kernel",
                                  "proj_weights_wide_kernel",
                                  "rel_attention_proj_fwd_wide_kernel")}
# the kernels that #3's and #4's sources may hold (their headers name
# them: rel_attention_bwd_passes.cuh's first forms, the wide forms of
# rel_attention_bwd_wide.cuh, and the batch sums over their operands), and
# the wide forms, which must be there
BACKWARD_KERNELS = ("bwd_keys_kernel", "bwd_queries_kernel", "bias_grad_kernel",
                    "outer_partial_mma_kernel", "outer_partial_copy_kernel",
                    "dw_sums_kernel")
WIDE_BACKWARD_KERNELS = ("bwd_rows_kernel", "bwd_keys_wide_kernel",
                         "bwd_queries_split_kernel", "dq_finish_kernel",
                         "bias_sums_kernel", "bias_rr_kernel")


def _forward_kernels_named() -> None:
    """Every kernel that the built library holds from #1's, #2's and #6's
    sources (``cuobjdump``: their anonymous namespaces carry the file's
    name) is one that ``FORWARD_KERNELS`` names (the kernels their headers
    name), and all of them are there: so a launch of #1, #2 or #6 at a wide
    width can reach no FMA kernel.  From #3's
    and #4's sources, every kernel is one that ``BACKWARD_KERNELS`` or
    ``WIDE_BACKWARD_KERNELS`` names, and the wide forms are there: so a wide
    launch of #3 or #4 reaches no kernel that their headers do not name.
    (The profiler, asked which kernel a launch ran, returned no event for
    one of them in a run of this phase, as it once did for #15's graph: it
    is no ground for a check.)"""
    import re

    from commu_tpu_torch.ops import _build

    sass = subprocess.run(
        [str(Path(_build._nvcc()).parent / "cuobjdump"), "-sass",
         str(_build._library_path())], capture_output=True, text=True,
        check=True).stdout
    for source, allowed in FORWARD_KERNELS.items():
        tag = "_" + source.replace(".", "_") + "_"
        names = {_kernel_name(m) for m in re.findall(
            r"Function : (\S+)", sass) if tag in m}
        if names != set(allowed):
            raise AssertionError(f"{source} holds the kernels "
                                 f"{sorted(names)}, not {allowed}")
        print(f"[wide] {source} holds {', '.join(sorted(names))} alone")
    for source in ("rel_attention_bwd.cu", "rel_attention_mem_bwd.cu"):
        tag = "_" + source.replace(".", "_") + "_"
        names = {_kernel_name(m) for m in re.findall(
            r"Function : (\S+)", sass) if tag in m}
        allowed = set(BACKWARD_KERNELS + WIDE_BACKWARD_KERNELS)
        if not names <= allowed or not set(WIDE_BACKWARD_KERNELS) <= names:
            raise AssertionError(f"{source} holds the kernels {sorted(names)}"
                                 f": not within {sorted(allowed)}, or "
                                 f"without {WIDE_BACKWARD_KERNELS}")
        print(f"[wide] {source} holds {', '.join(sorted(names))}")


def check_wide_kernels(card: str, proj_only: bool = False, b: int = 256,
                       t: int = 128) -> None:
    """``[wide]``: the wide forms of the attention kernels against their
    plain twins at the training shape (B = 256, T = 128, a full ring of R = 8
    slabs, M = 1024) at ``WIDE_WIDTHS``: #2 and #1 with the residual and #4
    and #3, each in the float form (16-bit masks) and the int8 form (8-bit
    masks), at p = 0.1 from a fixed seed, and #6 (float, with the
    residual), f32 and bf16; a rerun of each gives the same bits.  #4's dWk
    and dWv, sums over B x M = 262,144 terms, are held against the same sums
    in f64 (``_dw_mem_f64``; the f32 twin's distance to them printed).  #6
    must equal #5 + #2 on the same inputs bit for bit, in all five outputs;
    #5 alone (its twin, bound and one ``torch.matmul``) and the pair are
    timed, the pair in turns with #6, and with ``proj_only`` #6's launch is
    split into its CUDA kernels.  Prints the
    ``[kernel]`` lines and a ``[bound]`` line per form and dtype (no rows of
    the result line: these are forms of the kernels that have theirs).
    ``proj_only``: #6 and #5 alone (``--wide --proj``)."""
    import torch

    from commu_tpu_torch.ops import fused_attention as fa

    _forward_kernels_named()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(31)
    r_blocks, streams = 8, 3  # a ring of 3 layers, read at layer 2
    m_cap = r_blocks * t

    def randn(*shape, std=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    for d_model, heads, _ in WIDE_WIDTHS:
        dh = d_model // heads
        scale = 1.0 / dh ** 0.5
        for dtype, tol in ((torch.float32, F32_TOL),
                           (torch.bfloat16, BF16_TOL)):
            int8_tol = INT8_TOL.format(tol=tol, far=max(20 * tol, 5e-3))
            rows_tol = INT8_ROWS_TOL.format(tol=tol,
                                            far=max(20 * tol, 5e-3))
            q, k_win, v_win, dout = (randn(b, heads, dh, t, dtype=dtype)
                                     for _ in range(4))
            w_r = fa.pack_r_kernel(randn(d_model, d_model, std=0.05),
                                   heads).to(dtype)
            f2 = w_r.shape[2]
            if not fa.fwd_on_tensor_cores(dh, f2):
                raise AssertionError(f"{d_model}/{heads}: the forwards do "
                                     "not take these widths")
            rwbs, rrbs = fa._scaled_biases(randn(heads, dh, std=0.1),
                                           randn(heads, dh, std=0.1), scale,
                                           dtype)
            reset = (torch.arange(b, device=dev) % 50 == 7).int()
            mem = randn(streams, r_blocks, b, d_model, t, dtype=dtype)
            wk, wv = (randn(d_model, heads, dh, std=0.05) for _ in range(2))
            k_mem, v_mem = fa.project_mem_kv(mem, 2, wk, wv)
            for mc in (m_cap,) if proj_only else (m_cap, 0):
                shape = (f"units {d_model} heads {heads} (dh {dh}, 2F {f2}) "
                         f"B={b} T={t} M={mc}, p=0.1")
                k_len = mc + t
                psi = fa.ring_psi(fa.key_trig_basis(k_len, d_model, dtype,
                                                    dev), t, mc, 256 if mc
                                  else 0)
                trig_a = fa.query_trig_table(t, mc, d_model, dtype, dev)
                mask = fa.build_mask_bias(t, mc, mc, 256 if mc else 0, False,
                                          device=dev)
                pairs, mem_cols = _live(mask, reset, mc)
                if mc:
                    fwd = (q, rwbs, rrbs, k_mem, k_win, v_mem, v_win, w_r,
                           trig_a, psi, mask, reset, scale)
                    fwd_k, fwd_p = (fa.rel_attention_mem_fwd,
                                    fa.rel_attention_mem_fwd_plain)
                    bwd_k, bwd_p = (fa.rel_attention_mem_bwd,
                                    fa.rel_attention_mem_bwd_plain)
                    kernel = "rel_attention_mem"
                else:
                    fwd = (q, rwbs, rrbs, k_win, v_win, w_r, trig_a, psi,
                           mask, reset, scale)
                    fwd_k, fwd_p = (fa.rel_attention_fwd,
                                    fa.rel_attention_fwd_plain)
                    bwd_k, bwd_p = (fa.rel_attention_bwd,
                                    fa.rel_attention_bwd_plain)
                    kernel = "rel_attention"
                for int8 in () if proj_only else (False, True):
                    bits = 8 if int8 else 16
                    mode = dict(seed=DROPOUT_SEED, dropout_p=DROPOUT_P,
                                bits=bits)
                    psi_q = fa.quantize_psi_int8(psi) if int8 else None
                    if int8:
                        mode["psi_q"] = psi_q
                    form = "[int8]" if int8 else ""
                    out, s_res, lse = fwd_k(*fwd, save=True, **mode)
                    ref = fwd_p(*fwd, save=True, **mode)
                    if int8:
                        err = max(_compare_int8(f"{kernel}_fwd{form} out",
                                                out, ref[0], tol),
                                  _compare_int8_rows(f"{kernel}_fwd{form} S",
                                                     s_res, ref[1], tol),
                                  _compare_int8(f"{kernel}_fwd{form} lse",
                                                lse, ref[2], tol))
                    else:
                        live = ref[1] > -1e30
                        if not torch.equal(live, s_res > -1e30):
                            raise AssertionError(f"{kernel}_fwd {shape}: "
                                                 "masks differ")
                        err = max(_compare(f"{kernel}_fwd out", out, ref[0],
                                           tol),
                                  _compare_scaled(f"{kernel}_fwd S",
                                                  s_res[live], ref[1][live],
                                                  tol),
                                  _compare_scaled(f"{kernel}_fwd lse", lse,
                                                  ref[2], tol))
                        del live
                    _rerun_equal(f"{kernel}_fwd{form} wide",
                                 lambda: fwd_k(*fwd, save=True, **mode))
                    operands = fwd[:-1] + ((psi_q,) if int8 else ())
                    bd = heads * pairs * 2 * f2
                    _report_kernel(
                        {}, card, None, f"[wide] {kernel}_fwd{form} save=True",
                        shape, dtype, err, rows_tol if int8 else tol,
                        lambda: fwd_k(*fwd, save=True, **mode),
                        lambda: fwd_p(*fwd, save=True, **mode),
                        nbytes=_nbytes(*operands, out, s_res, lse),
                        bound_bf16=True,
                        **_attention_fwd_ops(dtype, b, heads, dh, t, f2,
                                             pairs, int8))
                    if mc:
                        bwd = (q, rwbs, rrbs, k_mem, k_win, v_mem, v_win, mem,
                               2, w_r, trig_a, psi, ref[1], ref[2], ref[0],
                               dout, scale)
                    else:
                        bwd = (q, rwbs, rrbs, k_win, v_win, w_r, trig_a, psi,
                               ref[1], ref[2], ref[0], dout, scale)
                    del ref
                    ours = bwd_k(*bwd, **mode)
                    twin = list(bwd_p(*bwd, **mode))
                    # the outputs the int8 dphi reaches: dq, dW_r, d r_r_bias;
                    # at dh 256 held by _compare_int8_position, where one
                    # tie moves a quarter of dW_r (by the count of elements
                    # at dh 64 and 128, where that held)
                    position = (0, 5, 7) if mc else (0, 3, 5)
                    by_position = int8 and dh > 128
                    exact = bwd_p(*bwd, seed=DROPOUT_SEED,
                                  dropout_p=DROPOUT_P, bits=bits) \
                        if by_position else None
                    if mc:  # dWk, dWv: sums over B x M terms, held in f64
                        for i, ref64 in zip((3, 4), _dw_mem_f64(bwd, mode)):
                            print(f"[wide] {kernel}_bwd{form} {shape} {dtype}"
                                  f" output {i} (a sum over {b * mc} terms) "
                                  f"against f64: kernel max abs err "
                                  f"{float((ours[i] - ref64).abs().max()):.3e},"
                                  f" f32 twin "
                                  f"{float((twin[i] - ref64).abs().max()):.3e}"
                                  f" (max|ref| "
                                  f"{float(ref64.abs().max()):.3e}) [{card}]")
                            twin[i] = ref64
                    err = 0.0
                    for i, (o, pl) in enumerate(zip(ours, twin)):
                        name = f"{kernel}_bwd{form} output {i} {dtype}"
                        if by_position and i in position:
                            err = max(err, _compare_int8_position(
                                name, o, pl, exact[i], tol))
                        else:
                            err = max(err, _compare_int8(name, o, pl, tol)
                                      if int8 else
                                      _compare_scaled(name, o, pl, tol))
                    del twin, exact
                    _rerun_equal(f"{kernel}_bwd{form} wide",
                                 lambda: bwd_k(*bwd, **mode))
                    tensors = [x for x in bwd[:-1]
                               if isinstance(x, torch.Tensor)]
                    if mc:  # the ring is read at one layer
                        tensors = [mem[2] if x is mem else x for x in tensors]
                    products = _attention_bwd_flops(b, heads, dh, t, f2,
                                                    d_model, pairs, mem_cols)
                    _report_kernel(
                        {}, card, None, f"[wide] {kernel}_bwd{form}", shape,
                        dtype, err, int8_tol + "; " + INT8_POSITION_TOL.format(
                            far=max(20 * tol, 5e-3)) if by_position
                        else int8_tol if int8 else tol,
                        lambda: bwd_k(*bwd, **mode),
                        lambda: bwd_p(*bwd, **mode),
                        nbytes=_nbytes(*tensors, *ours,
                                       *((psi_q,) if int8 else ())),
                        bound_bf16=True, int8_ops=bd if int8 else 0,
                        **_tensor_core_ops(dtype, products
                                           - (bd if int8 else 0)))
                    del ours, bwd, tensors, out, s_res, lse
                if mc:
                    _check_wide_proj(card, shape, dtype, tol, fwd, mem, wk,
                                     wv, pairs, proj_only)
            del q, k_win, v_win, dout, mem, k_mem, v_mem
            torch.cuda.empty_cache()


def _check_wide_proj(card, shape, dtype, tol, fwd, mem, wk, wv, pairs,
                     split=False):
    """``check_wide_kernels``' #6 at one wide width: the float form (the
    reference has no other) with the residual at p = 0.1, against its twin
    and against #5 + #2 on the same inputs (``fwd``: #2's operands over
    ``project_mem_kv(mem, 2, wk, wv)``'s slabs), bit for bit in k_mem,
    v_mem, out, S and lse; a rerun's bits; with ``split``, its launch split
    into its CUDA kernels (``[passes]``: ``--wide --proj`` alone, as the
    profiler recorded no device time there in the full run once); #6 and #5
    alone against their twins with their bounds (#5 beside one
    ``torch.matmul``); then the pair and #6 in turns (pair, #6, #6, pair; 3
    launches each after a warm one)."""
    import torch

    from commu_tpu_torch.ops import fused_attention as fa

    q, rwbs, rrbs, k_mem, k_win, v_mem, v_win, w_r = fwd[:8]
    b, heads, dh, t = q.shape
    d_model, m_cap, f2 = mem.shape[3], mem.shape[1] * mem.shape[4], \
        w_r.shape[2]
    drop = dict(seed=DROPOUT_SEED, dropout_p=DROPOUT_P)
    tail = fwd[4:5] + fwd[6:]

    def proj():
        return fa.rel_attention_proj_fwd(q, rwbs, rrbs, mem, 2, wk, wv, *tail,
                                         save=True, **drop)

    def pair():
        km, vm = fa.project_mem_kv(mem, 2, wk, wv)
        return fa.rel_attention_mem_fwd(q, rwbs, rrbs, km, k_win, vm, v_win,
                                        *fwd[7:], save=True, **drop)

    ours = proj()
    wk2, wv2 = (w.reshape(d_model, heads * dh).to(dtype) for w in (wk, wv))
    ref = fa.rel_attention_proj_fwd_plain(q, rwbs, rrbs, mem, 2, wk2, wv2,
                                          *tail, save=True, **drop)
    live = ref[3] > -1e30
    if not torch.equal(live, ours[3] > -1e30):
        raise AssertionError(f"rel_attention_proj_fwd {shape} {dtype}: masks "
                             "differ from its twin's")
    err = max(_compare("rel_attention_proj_fwd out", ours[0], ref[0], tol),
              _compare("rel_attention_proj_fwd k_mem", ours[1], ref[1], tol),
              _compare("rel_attention_proj_fwd v_mem", ours[2], ref[2], tol),
              _compare_scaled("rel_attention_proj_fwd S", ours[3][live],
                              ref[3][live], tol),
              _compare_scaled("rel_attention_proj_fwd lse", ours[4], ref[4],
                              tol))
    del ref, live
    two = fa.rel_attention_mem_fwd(*fwd, save=True, **drop)
    same = {name: torch.equal(x, y) for name, x, y in zip(
        ("k_mem", "v_mem", "out", "S", "lse"), ours[1:3] + ours[:1] + ours[3:],
        (k_mem, v_mem) + tuple(two))}
    print(f"[wide] rel_attention_proj_fwd save=True {shape} {dtype}: equal "
          f"to #5 + #2 bit for bit: "
          f"{', '.join(f'{n} {v}' for n, v in same.items())} [{card}]")
    if not all(same.values()):
        raise AssertionError(f"rel_attention_proj_fwd {shape} {dtype}: not "
                             f"#5 + #2's bits: {same}")
    del two
    _rerun_equal("rel_attention_proj_fwd wide", proj)
    if split:
        _print_passes(f"rel_attention_proj_fwd save=True {shape} {dtype}",
                      card, proj)
    proj_ops = 2 * 2 * b * m_cap * d_model * heads * dh
    _report_kernel(
        {}, card, None, "[wide] rel_attention_proj_fwd save=True", shape,
        dtype, err, tol, proj,
        lambda: fa.rel_attention_proj_fwd_plain(
            q, rwbs, rrbs, mem, 2, wk2, wv2, *tail, save=True, **drop),
        nbytes=_nbytes(q, rwbs, rrbs, mem[2], wk2, wv2, *tail[:-1], *ours),
        bound_bf16=True,
        **_mma_fwd_ops(dtype, proj_ops + _attention_flops(b, heads, dh, t, f2,
                                                          pairs)))
    del ours
    kp, vp = fa.project_mem_kv_plain(mem, 2, wk2, wv2)
    err = max(_compare("project_mem_kv wide", k_mem.reshape(kp.shape), kp,
                       tol),
              _compare("project_mem_kv wide", v_mem.reshape(vp.shape), vp,
                       tol))
    del kp, vp
    _report_kernel(
        {}, card, None, "[wide] project_mem_kv", shape, dtype, err, tol,
        lambda: fa.project_mem_kv(mem, 2, wk, wv),
        lambda: fa.project_mem_kv_plain(mem, 2, wk2, wv2),
        nbytes=_nbytes(mem[2], wk2, wv2, k_mem, v_mem),
        library=_matmul_kv(mem, 2, wk2, wv2), bound_bf16=True,
        **_tensor_core_ops(dtype, proj_ops))
    runs = (pair, proj)
    p1, s1, s2, p2 = (_cuda_ms(runs[i], 3, 1) for i in (0, 1, 1, 0))
    print(f"[wide] in turns project_mem_kv + rel_attention_mem_fwd against "
          f"rel_attention_proj_fwd save=True {shape} {dtype}: #5 + #2 "
          f"{p1:.4f} / {p2:.4f} ms, #6 {s1:.4f} / {s2:.4f} ms, #6 at "
          f"{(s1 + s2) / (p1 + p2):.3f}x the pair's time [{card}]",
          flush=True)


def _wide_bwd_inputs(d_model, heads, dtype, mc, int8, gen, b=256, t=128,
                     r_blocks=8):
    """One launch's operands of #4 (``mc`` > 0: a ring of ``r_blocks`` slabs
    read at layer 2) or #3 (``mc`` 0) at a wide width, from ``gen``: the
    forward kernel's residual (p = 0.1, 16-bit masks, or 8-bit with psi_q in
    the int8 form) -> (bwd, mode, pairs, mem_cols, backward, kernel)."""
    import torch

    from commu_tpu_torch.ops import fused_attention as fa

    dev = gen.device
    dh = d_model // heads
    scale = 1.0 / dh ** 0.5

    def randn(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    q, k_win, v_win, dout = (randn(b, heads, dh, t) for _ in range(4))
    w_r = fa.pack_r_kernel(randn(d_model, d_model, std=0.05), heads).to(dtype)
    rwbs, rrbs = fa._scaled_biases(randn(heads, dh, std=0.1),
                                   randn(heads, dh, std=0.1), scale, dtype)
    reset = (torch.arange(b, device=dev) % 50 == 7).int()
    k_len = mc + t
    psi = fa.ring_psi(fa.key_trig_basis(k_len, d_model, dtype, dev), t, mc,
                      256 if mc else 0)
    trig_a = fa.query_trig_table(t, mc, d_model, dtype, dev)
    mask = fa.build_mask_bias(t, mc, mc, 256 if mc else 0, False, device=dev)
    pairs, mem_cols = _live(mask, reset, mc)
    mode = dict(seed=DROPOUT_SEED, dropout_p=DROPOUT_P, bits=8 if int8 else 16)
    if int8:
        mode["psi_q"] = fa.quantize_psi_int8(psi)
    if mc:
        mem = randn(3, r_blocks, b, d_model, t)
        k_mem, v_mem = fa.project_mem_kv(
            mem, 2, *(randn(d_model, heads, dh, std=0.05) for _ in range(2)))
        out, s_res, lse = fa.rel_attention_mem_fwd(
            q, rwbs, rrbs, k_mem, k_win, v_mem, v_win, w_r, trig_a, psi, mask,
            reset, scale, save=True, **mode)
        bwd = (q, rwbs, rrbs, k_mem, k_win, v_mem, v_win, mem, 2, w_r,
               trig_a, psi, s_res, lse, out, dout, scale)
        return bwd, mode, pairs, mem_cols, fa.rel_attention_mem_bwd, \
            "rel_attention_mem_bwd"
    out, s_res, lse = fa.rel_attention_fwd(
        q, rwbs, rrbs, k_win, v_win, w_r, trig_a, psi, mask, reset, scale,
        save=True, **mode)
    bwd = (q, rwbs, rrbs, k_win, v_win, w_r, trig_a, psi, s_res, lse, out,
           dout, scale)
    return bwd, mode, pairs, 0, fa.rel_attention_bwd, "rel_attention_bwd"


def _bwd_pass_bounds(dtype, int8, b, h, dh, t, k_len, f2, d_model, pairs,
                     mem_cols, elt) -> dict:
    """The least ms of each group of #3's and #4's CUDA kernels on this
    launch's inputs: {group: (ms, "bytes" or "operations")}.  Pass A: dP,
    dv, dk per unmasked score (dP a product of the function, so at the
    tensor-core rate though the f32 kernel runs it on FMA for the int8
    quantiser's bits, as ``_attention_bwd_flops`` counts it), reading S,
    lse, q, dO, O and v and writing ds (f32) and dk, dv; pass B: ds psi^T
    (int8: at the int8 rate) and k ds^T per unmasked score, W_r du^T per
    row, reading ds, k, psi, W_r and trig_a and writing dq and du (f32);
    dWk + dWv: 2 H dh D per memory column that some query sees, each way,
    reading the f32 dk and dv of the memory and the ring's layer; dW_r: qr
    du per row.  Each tensor-core product at its type's rate (3 TF32 passes
    in f32)."""
    import torch

    f32 = dtype == torch.float32
    tc = (3 / TF32_FLOPS_PER_S) if f32 else (1 / BF16_FLOPS_PER_S)
    bh, m = b * h, k_len - t
    ops = {"pass A": h * pairs * 6 * dh * tc,
           "pass B": (h * pairs * 2 * f2 * (1 / INT8_OPS_PER_S if int8
                                            else tc)
                      + (h * pairs * 2 * dh + bh * 2 * t * f2 * dh) * tc),
           "dWk + dWv": 4 * mem_cols * h * dh * d_model * tc,
           "dW_r": bh * 2 * t * f2 * dh * tc}
    nbytes = {"pass A": bh * t * k_len * 8 + bh * (3 * dh * t + dh * k_len)
              * elt + bh * dh * (t * elt + m * 4) * 2,
              "pass B": bh * t * k_len * 4 + bh * dh * k_len * elt
              + (k_len * f2 * (1 if int8 else elt)) + bh * dh * t * elt
              + bh * t * f2 * 4,
              "dWk + dWv": 2 * bh * dh * m * 4 + b * d_model * m * elt
              + 2 * h * dh * d_model * 4,
              "dW_r": bh * (dh * t * elt + t * f2 * 4) + h * dh * f2 * 4}
    return {g: (max(1e3 * ops[g], 1e3 * nbytes[g] / HBM_BYTES_PER_S),
                "operations" if ops[g] * HBM_BYTES_PER_S >= nbytes[g]
                else "bytes") for g in ops if ops[g] or g != "dWk + dWv"}


def report_dw_sums(card, dtype, d_model, hd, b=256, m_cap=1024, seed=24):
    """``[kernel]`` and ``[bound]`` lines of #4's dWk + dWv batch sums
    alone: ``csrc/sums.cu``'s ``sum_outer_wg`` (the warpgroup product that
    ``rel_attention_mem_bwd.cu`` launches, dk and dv as two parts of one
    launch) at #4's shape (B batch rows of M = ``m_cap`` memory tokens)
    on seeded operands, against their sum in f64 (f32: within 1e-4 of
    max|ref|; bf16: the f32 A rounded to bf16 first, as the kernel rounds
    it, within 2e-2 of max|ref|), with a plain ``torch.einsum`` in f32 and
    one ``torch.matmul`` (``_matmul_dw_mem``'s layout) beside it."""
    import torch

    from commu_tpu_torch.ops import _build

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randn(2, b, hd, m_cap, generator=gen, device=dev)
    ring = torch.randn(b, d_model, m_cap, generator=gen, device=dev).to(dtype)
    out = torch.empty(2, hd, d_model, device=dev)
    lib = _build.library()
    scratch = torch.empty(max(1, int(lib.commu_sum_outer_wg_workspace(
        hd, d_model, b, m_cap, 2))), dtype=torch.uint8, device=dev)
    code = 0 if dtype == torch.float32 else 1

    def run():
        err = lib.commu_sum_outer_wg(
            code, a.data_ptr(), ring.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), hd, d_model, b, m_cap, 2,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"sum_outer_wg: CUDA error {err}")
    run()
    first = out.clone()
    run()
    torch.cuda.synchronize()
    if not torch.equal(first, out):
        raise AssertionError("dWk + dWv sums: two runs on the same inputs "
                             "differ")
    a_r = a.to(dtype).double()
    ref = torch.einsum("pbmt,bnt->pmn", a_r, ring.double())
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    err = float((out.double() - ref).abs().max()) / float(ref.abs().max())
    if not err <= tol:
        raise AssertionError(f"dWk + dWv sums {dtype}: max abs err {err:.3e} "
                             f"of max|ref| exceeds {tol}")
    del a_r, ref
    ring_t = ring.permute(1, 0, 2).reshape(d_model, b * m_cap).contiguous()
    a_t = a.to(dtype).permute(1, 3, 0, 2).reshape(b * m_cap, 2 * hd)
    a_t = a_t.contiguous()
    _report_kernel(
        {}, card, None, "dWk + dWv sums (rel_attention_mem_bwd's warpgroup "
        "product, sum_outer_wg)", f"H dh={hd} D={d_model} B={b} M={m_cap}",
        dtype, err, f"{tol} x max|ref| of f64, two runs bit-equal", run,
        lambda: torch.einsum("pbmt,bnt->pmn", a, ring.float()),
        nbytes=_nbytes(a, ring, out),
        library=lambda: torch.matmul(ring_t, a_t), bound_bf16=True,
        **_tensor_core_ops(dtype, 2 * 2 * hd * d_model * b * m_cap))
    del a, ring, out, scratch, ring_t, a_t
    torch.cuda.empty_cache()


def _sums_library_ms(mem, hd, dtype) -> float:
    """ms of ``_matmul_dw_mem`` on the slabs of layer 2 of ``mem``."""
    import torch

    ms = _cuda_ms(_matmul_dw_mem(mem, 2, hd, dtype), 3, 1)
    torch.cuda.empty_cache()
    return ms


def _print_sums_yardsticks(dtype, b, heads, dh, t, m_cap, f2, d_model, pairs,
                           mem_cols, mem) -> None:
    """The ``[passes]`` lines under a split of #4 at ``ModelConfig()``: the
    least time of its dWk + dWv sums on these inputs and one
    ``torch.matmul`` of the same product."""
    import torch

    ms, by = _bwd_pass_bounds(
        dtype, False, b, heads, dh, t, m_cap + t, f2, d_model, pairs,
        mem_cols, torch.empty((), dtype=dtype).element_size())["dWk + dWv"]
    print(f"[passes]   bound dWk + dWv: {ms:.4f} ms by {by}")
    print(f"[passes]   library dWk + dWv: "
          f"{_sums_library_ms(mem, heads * dh, dtype):.4f} ms (one "
          f"torch.matmul [D, B M] x [B M, 2 H dh])")


def time_wide_bwd_passes(card: str, b: int = 256, t: int = 128) -> None:
    """``[passes] wide``: one launch of #4 (train shape: B = 256, T = 128, a
    full ring of 8 slabs) and one of #3 (the T0 shape: the window alone) at
    each of ``WIDE_WIDTHS``, f32 and bf16, the float form (16-bit masks) and
    the int8 form (8-bit masks), p = 0.1, split into their CUDA kernels by
    ``torch.profiler`` (``_print_passes``), with the least time of each
    group of kernels on the same inputs (``_bwd_pass_bounds``)."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(41)
    for d_model, heads, _ in WIDE_WIDTHS:
        dh = d_model // heads
        for dtype in (torch.float32, torch.bfloat16):
            for mc in (8 * t, 0):
                for int8 in (False, True):
                    bwd, mode, pairs, mem_cols, fn, kernel = _wide_bwd_inputs(
                        d_model, heads, dtype, mc, int8, gen, b, t)
                    f2 = bwd[9 if mc else 5].shape[2]
                    form = "[int8]" if int8 else ""
                    what = (f"{kernel}{form} units {d_model} heads {heads} "
                            f"(dh {dh}, 2F {f2}) B={b} T={t} M={mc}, p=0.1 "
                            f"{str(dtype).split('.')[-1]}")
                    _print_passes(f"wide {what}", card, lambda: fn(*bwd, **mode))
                    for group, (ms, by) in _bwd_pass_bounds(
                            dtype, int8, b, heads, dh, t, mc + t, f2, d_model,
                            pairs, mem_cols,
                            torch.empty((), dtype=dtype).element_size()).items():
                        print(f"[passes]   bound {group}: {ms:.4f} ms by {by}")
                    if mc:
                        print(f"[passes]   library dWk + dWv: "
                              f"{_sums_library_ms(bwd[7], heads * dh, dtype):.4f}"
                              f" ms (one torch.matmul [D, B M] x [B M, 2 H dh])")
                    del bwd
                    torch.cuda.empty_cache()


def time_kv(card: str, b: int = 256, t: int = 128) -> None:
    """``--kv`` (and ``--passes``): #5 at ``ModelConfig()``'s training shape
    (B = 256, a full ring of 8 slabs of 128) and eval shape (B = 10, 16
    slabs) and at each of ``WIDE_WIDTHS``' training shape, f32 and bf16,
    against its twin with its ``[bound]`` line and one ``torch.matmul``;
    then at ``ModelConfig()`` and at each wide width, f32 and bf16, #4's
    dWk + dWv sums alone (``report_dw_sums``, where this commit has the
    warpgroup product) and one launch of #4 (training shape, p = 0.1), its
    float form (16-bit masks)
    and int8 form (8-bit masks), by CUDA events, beside the least time of
    its dWk + dWv sums and one ``torch.matmul`` of that product (``[kv]``
    lines), and under ``--passes`` its split into CUDA kernels
    (``[passes]``).  Copied into a checkout of another commit it times that
    commit's kernels, so parent, tree, tree, parent in one call compare
    them in turns."""
    import torch

    from commu_tpu_torch.ops import _build
    from commu_tpu_torch.ops import fused_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(24)
    widths = ((500, 10),) + tuple((d, h) for d, h, _ in WIDE_WIDTHS)
    shapes = [(500, 10, 10, 16)] + [(d, h, b, 8) for d, h in widths]
    for d_model, heads, bb, r_blocks in shapes:
        dh = d_model // heads
        for dtype, tol in ((torch.float32, F32_TOL),
                           (torch.bfloat16, BF16_TOL)):
            mem = (torch.randn(3, r_blocks, bb, d_model, t, generator=gen,
                               device=dev)).to(dtype)
            wk, wv = (torch.randn(d_model, heads, dh, generator=gen,
                                  device=dev) * 0.05 for _ in range(2))
            wk2, wv2 = (w.reshape(d_model, -1).to(dtype) for w in (wk, wv))
            k_mem, v_mem = fa.project_mem_kv(mem, 2, wk, wv)
            kp, vp = fa.project_mem_kv_plain(mem, 2, wk2, wv2)
            err = max(_compare(f"project_mem_kv {dtype}",
                               k_mem.reshape(kp.shape), kp, tol),
                      _compare(f"project_mem_kv {dtype}",
                               v_mem.reshape(vp.shape), vp, tol))
            del kp, vp
            _rerun_equal(f"project_mem_kv {dtype}",
                         lambda: fa.project_mem_kv(mem, 2, wk, wv))
            shape = (f"units {d_model} heads {heads} B={bb} R={r_blocks} "
                     f"Tb={t}")
            _report_kernel(
                {}, card, None, "[kv] project_mem_kv", shape, dtype, err, tol,
                lambda: fa.project_mem_kv(mem, 2, wk, wv),
                lambda: fa.project_mem_kv_plain(mem, 2, wk2, wv2),
                nbytes=_nbytes(mem[2], wk2, wv2, k_mem, v_mem),
                library=_matmul_kv(mem, 2, wk2, wv2), bound_bf16=True,
                **_tensor_core_ops(dtype, 4 * d_model * heads * dh * bb
                                   * r_blocks * t))
            del mem, k_mem, v_mem
            torch.cuda.empty_cache()
    for d_model, heads in widths:
        dh = d_model // heads
        for dtype in (torch.float32, torch.bfloat16):
            if hasattr(_build.library(), "commu_kv_product"):
                report_dw_sums(card, dtype, d_model, heads * dh, b, 8 * t)
            for int8 in (False, True):
                bwd, mode, pairs, mem_cols, fn, kernel = _wide_bwd_inputs(
                    d_model, heads, dtype, 8 * t, int8, gen, b, t)
                f2 = bwd[9].shape[2]
                ms = _cuda_ms(lambda: fn(*bwd, **mode), 3, 1)
                bound, by = _bwd_pass_bounds(
                    dtype, int8, b, heads, dh, t, 9 * t, f2, d_model, pairs,
                    mem_cols, torch.empty((), dtype=dtype).element_size()
                )["dWk + dWv"]
                lib = _sums_library_ms(bwd[7], heads * dh, dtype)
                if PASSES:
                    _print_passes(f"{kernel}{'[int8]' if int8 else ''} units "
                                  f"{d_model} heads {heads} "
                                  f"{str(dtype).split('.')[-1]}", card,
                                  lambda: fn(*bwd, **mode))
                print(f"[kv] {kernel}{'[int8]' if int8 else ''} units "
                      f"{d_model} heads {heads} B={b} T={t} M={8 * t}, p=0.1 "
                      f"{str(dtype).split('.')[-1]}: {ms:.4f} ms; dWk + dWv "
                      f"bound {bound:.4f} ms by {by}, library {lib:.4f} ms "
                      f"[{card}]", flush=True)
                del bwd
                torch.cuda.empty_cache()


def _parent_build(parent: Path, names, tag: str):
    """The sources ``csrc/<name>.cu`` of the checkout at ``parent``,
    compiled with this build's flags (one nvcc a source, side by side) and
    linked into one library under ``_build/<tag>`` -> (the library, the
    parent's own ``ops/_build.py`` as a module, for its argument lists)."""
    import ctypes
    import importlib.util

    from commu_tpu_torch.ops import _build

    spec = importlib.util.spec_from_file_location(
        f"_parent_build_{tag}", parent / "commu_tpu_torch" / "ops" / "_build.py")
    theirs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(theirs)
    src = parent / "commu_tpu_torch" / "csrc"
    out = _build.BUILD_DIR / tag
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    jobs = [subprocess.Popen(
        [nvcc, *_build.NVCC_FLAGS, "-c", "-o", str(out / f"{n}.o"),
         str(src / f"{n}.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for n in names]
    for job in jobs:
        log = job.communicate()[0]
        if job.returncode:
            raise RuntimeError(f"the parent's {tag}: nvcc failed\n{log}")
    lib_path = out / f"lib{tag}.so"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-shared", "-o", str(lib_path),
                    *(str(out / f"{n}.o") for n in names)], check=True,
                   capture_output=True)
    return ctypes.CDLL(str(lib_path)), theirs


def _parent_forwards(parent: Path):
    """The three attention forwards (#1, #2, #6) of the checkout at
    ``parent``, compiled from its sources with this build's flags into one
    library (``_parent_build``), and a call of #1's and #2's
    workspace query, ``workspace(name, dtype_code, int8, B, H, dh, T, 2F)``.
    The argument lists are the parent's own ``ops/_build.py``'s: an entry
    point that takes other arguments than this tree's, #6's query if it
    differs from this tree's, or #1's or #2's of another form than (B, H,
    dh, T, 2F) or (dtype, int8, B, H, dh, T, 2F), is refused."""
    import ctypes

    from commu_tpu_torch.ops import _build

    names = ("rel_attention_fwd", "rel_attention_mem_fwd",
             "rel_attention_proj_fwd")
    lib, theirs = _parent_build(parent, names, "parent_forwards")
    arity = {}
    for n in names:
        sig = theirs._SIGNATURES[f"commu_{n}"]
        if sig != _build._SIGNATURES[f"commu_{n}"]:
            raise RuntimeError(f"the parent's commu_{n} takes other "
                               "arguments than this tree's")
        fn = getattr(lib, f"commu_{n}")
        fn.argtypes, fn.restype = sig, ctypes.c_int
        wsig = theirs._WORKSPACE[f"commu_{n}_workspace"]
        if n == "rel_attention_proj_fwd":
            known = wsig == _build._WORKSPACE[f"commu_{n}_workspace"]
        else:
            known = wsig == [ctypes.c_int] * len(wsig) and len(wsig) in (5, 7)
        if not known:
            raise RuntimeError(f"the parent's commu_{n}_workspace takes "
                               f"{len(wsig)} arguments of a form not known "
                               "here")
        query = getattr(lib, f"commu_{n}_workspace")
        query.argtypes, query.restype = wsig, ctypes.c_longlong
        arity[n] = len(wsig)

    def workspace(n, code, int8, *shape):
        args = shape if arity[n] == 5 else (code, int(int8), *shape)
        return getattr(lib, f"commu_{n}_workspace")(*args)

    return lib, workspace


def _parent_backwards(parent: Path):
    """The attention backwards #3 and #4 of the checkout at ``parent``,
    compiled from its sources (``_parent_build``) and bound with its own
    argument lists, which must be this tree's (else refused): a library
    that ``_library_as`` puts in the place of this tree's."""
    import ctypes

    from commu_tpu_torch.ops import _build

    names = ("rel_attention_bwd", "rel_attention_mem_bwd")
    lib, theirs = _parent_build(parent, names, "parent_backwards")
    for n in names:
        for key, table, mine, ret in (
                (f"commu_{n}", theirs._SIGNATURES, _build._SIGNATURES,
                 ctypes.c_int),
                (f"commu_{n}_workspace", theirs._WORKSPACE, _build._WORKSPACE,
                 ctypes.c_longlong)):
            if table[key] != mine[key]:
                raise RuntimeError(f"the parent's {key} takes other "
                                   "arguments than this tree's")
            fn = getattr(lib, key)
            fn.argtypes, fn.restype = table[key], ret
    return lib


@contextlib.contextmanager
def _library_as(lib):
    """Inside, ``_build.library()`` answers with ``lib``: this tree's
    wrappers launch its entry points (and query its workspaces)."""
    from commu_tpu_torch.ops import _build

    tree = _build.library
    _build.library = lambda: lib
    try:
        yield
    finally:
        _build.library = tree


def wide_bwd_in_turns(card: str, parent: Path, b: int = 256,
                      t: int = 128) -> None:
    """``[wide] in turns``: #4 (train shape: B = 256, T = 128, a full ring of
    8 slabs) and #3 (the T0 shape: the window alone) at p = 0.1, float form
    (16-bit masks) and int8 form (8-bit masks), f32 and bf16, at
    ``WIDE_WIDTHS``: ``parent``'s kernels (``_parent_backwards``) and this
    tree's, each through this tree's wrapper, timed in turns (parent, tree,
    tree, parent; 3 launches each after a warm one), every output of the
    parent's held against this tree's within the tolerance (the int8 form
    by ``_compare_int8``)."""
    import torch

    lib = _parent_backwards(parent)
    gen = torch.Generator(device=torch.device("cuda")).manual_seed(43)
    for d_model, heads, _ in WIDE_WIDTHS:
        dh = d_model // heads
        for dtype, tol in ((torch.float32, F32_TOL),
                           (torch.bfloat16, BF16_TOL)):
            for mc in (8 * t, 0):
                for int8 in (False, True):
                    bwd, mode, _, _, fn, kernel = _wide_bwd_inputs(
                        d_model, heads, dtype, mc, int8, gen, b, t)

                    def parent_run():
                        with _library_as(lib):
                            return fn(*bwd, **mode)

                    def tree_run():
                        return fn(*bwd, **mode)

                    tree, old = tree_run(), parent_run()
                    form = "[int8]" if int8 else ""
                    for i, (o, x) in enumerate(zip(old, tree)):
                        name = f"{kernel}{form} parent against tree, output {i}"
                        if int8:
                            _compare_int8(name, o, x, tol)
                        else:
                            _compare_scaled(name, o, x, tol)
                    del tree, old
                    runs = (parent_run, tree_run)
                    p1, t1, t2, p2 = (_cuda_ms(runs[i], 3, 1)
                                      for i in (0, 1, 1, 0))
                    print(f"[wide] in turns {kernel}{form} units {d_model} "
                          f"heads {heads} (dh {dh}, 2F "
                          f"{bwd[9 if mc else 5].shape[2]}) B={b} T={t} "
                          f"M={mc}, p=0.1 {dtype}: parent {p1:.4f} / "
                          f"{p2:.4f} ms, tree {t1:.4f} / {t2:.4f} ms, "
                          f"{(p1 + p2) / (t1 + t2):.2f}x faster [{card}]",
                          flush=True)
                    del bwd
                    torch.cuda.empty_cache()


def wide_in_turns(card: str, parent: Path, proj_only: bool = False,
                  b: int = 256, t: int = 128) -> None:
    """``[wide] in turns``: #2 (train shape: B = 256, T = 128, a full ring
    of 8 slabs) and #1 (the T0 shape: the window alone), with the residual
    at p = 0.1, in the float form (16-bit masks) and the int8 form (8-bit
    masks), f32 and bf16, at ``WIDE_WIDTHS``, and #6 (the projecting
    forward) at the train shape: the form built from ``parent``'s sources
    (``_parent_forwards``) and this tree's, timed in turns (parent, tree,
    tree, parent; 3 launches each after a warm one), with the parent's out
    held against this tree's within the tolerance.  ``proj_only``: #6
    alone (``--wide --proj``)."""
    import torch

    from commu_tpu_torch.ops import fused_attention as fa
    from commu_tpu_torch.ops import prng

    lib, workspace = _parent_forwards(parent)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(37)

    def randn(*shape, std=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    def parent_call(mem, fwd, mode):
        q, w_r = fwd[0], fwd[7 if mem else 5]
        bb, h, dh, tt = q.shape
        f2 = w_r.shape[2]
        psi_q = mode.get("psi_q")
        words = fa._words_along_depth(psi_q) if psi_q is not None else None
        drop = prng.kernel_args(mode["seed"], mode["dropout_p"], mode["bits"])
        code = 0 if q.dtype == torch.float32 else 1
        stream = torch.cuda.current_stream(dev).cuda_stream
        out = torch.empty_like(q)
        if mem:
            k_mem = fwd[3]
            r, tb = k_mem.shape[1], k_mem.shape[4]
            k_len = r * tb + tt
            nbytes = workspace("rel_attention_mem_fwd", code,
                               psi_q is not None, bb, h, dh, tt, f2)
        else:
            k_len = tt
            nbytes = workspace("rel_attention_fwd", code, psi_q is not None,
                               bb, h, dh, tt, f2)
        s_res = torch.empty((bb, h, tt, k_len), dtype=torch.float32,
                            device=dev)
        lse = torch.empty((bb, h, tt), dtype=torch.float32, device=dev)
        work = torch.empty((nbytes,), dtype=torch.uint8, device=dev) \
            if nbytes else None
        ptrs = [x.data_ptr() for x in fwd[:-1]]
        wp = None if work is None else work.data_ptr()
        wd = None if words is None else words.data_ptr()
        if mem:
            err = lib.commu_rel_attention_mem_fwd(
                code, *ptrs, out.data_ptr(), s_res.data_ptr(),
                lse.data_ptr(), wd, bb, h, dh, tt, r, tb, f2,
                float(fwd[-1]), *drop, wp, stream)
        else:
            q, rwbs, rrbs, k, v, w_r, trig_a, psi, mask, reset = fwd[:-1]
            err = lib.commu_rel_attention_fwd(
                code, *(x.data_ptr() for x in (q, k, v, rwbs, rrbs, w_r,
                                                trig_a, psi)), wd,
                mask.data_ptr(), reset.data_ptr(), out.data_ptr(),
                s_res.data_ptr(), lse.data_ptr(), bb, h, dh, tt, f2,
                float(fwd[-1]), *drop, wp, stream)
        if err:
            raise RuntimeError(f"the parent's forward: CUDA error {err}")
        return out, s_res, lse

    def parent_proj(args, drop):
        q, mem, wk, w_r = args[0], args[3], args[4], args[8]
        bb, h, dh, tt = q.shape
        r, d_model, tb = mem.shape[1], mem.shape[3], mem.shape[4]
        f2 = w_r.shape[2]
        code = 0 if q.dtype == torch.float32 else 1
        out = torch.empty_like(q)
        k_mem, v_mem = (torch.empty((bb, r, h, dh, tb), dtype=q.dtype,
                                    device=dev) for _ in range(2))
        s_res = torch.empty((bb, h, tt, r * tb + tt), dtype=torch.float32,
                            device=dev)
        lse = torch.empty((bb, h, tt), dtype=torch.float32, device=dev)
        nbytes = lib.commu_rel_attention_proj_fwd_workspace(code, bb, d_model,
                                                            h, dh, f2)
        work = torch.empty((max(int(nbytes), 1),), dtype=torch.uint8,
                           device=dev)
        err = lib.commu_rel_attention_proj_fwd(
            code, *(x.data_ptr() for x in args[:-1]), out.data_ptr(),
            k_mem.data_ptr(), v_mem.data_ptr(), s_res.data_ptr(),
            lse.data_ptr(), work.data_ptr(), 2, bb, h, dh, tt, r, tb, d_model,
            f2, float(args[-1]), *drop,
            torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"the parent's #6: CUDA error {err}")
        return out, k_mem, v_mem, s_res, lse

    r_blocks = 8
    m_cap = r_blocks * t
    for d_model, heads, _ in WIDE_WIDTHS:
        dh = d_model // heads
        scale = 1.0 / dh ** 0.5
        for dtype, tol in ((torch.float32, F32_TOL),
                           (torch.bfloat16, BF16_TOL)):
            q, k_win, v_win = (randn(b, heads, dh, t, dtype=dtype)
                               for _ in range(3))
            k_mem, v_mem = (randn(b, r_blocks, heads, dh, t, dtype=dtype)
                            for _ in range(2))
            w_r = fa.pack_r_kernel(randn(d_model, d_model, std=0.05),
                                   heads).to(dtype)
            rwbs, rrbs = fa._scaled_biases(randn(heads, dh, std=0.1),
                                           randn(heads, dh, std=0.1), scale,
                                           dtype)
            reset = (torch.arange(b, device=dev) % 50 == 7).int()
            for mc in (m_cap,) if proj_only else (m_cap, 0):
                k_len = mc + t
                psi = fa.ring_psi(fa.key_trig_basis(k_len, d_model, dtype,
                                                    dev), t, mc,
                                  256 if mc else 0)
                trig_a = fa.query_trig_table(t, mc, d_model, dtype, dev)
                mask = fa.build_mask_bias(t, mc, mc, 256 if mc else 0, False,
                                          device=dev)
                if mc:
                    fwd = (q, rwbs, rrbs, k_mem, k_win, v_mem, v_win, w_r,
                           trig_a, psi, mask, reset, scale)
                    ours_fn, kernel = fa.rel_attention_mem_fwd, \
                        "rel_attention_mem_fwd"
                else:
                    fwd = (q, rwbs, rrbs, k_win, v_win, w_r, trig_a, psi,
                           mask, reset, scale)
                    ours_fn, kernel = fa.rel_attention_fwd, "rel_attention_fwd"
                for int8 in () if proj_only else (False, True):
                    mode = dict(seed=DROPOUT_SEED, dropout_p=DROPOUT_P,
                                bits=8 if int8 else 16)
                    if int8:
                        mode["psi_q"] = fa.quantize_psi_int8(psi)
                    tree = ours_fn(*fwd, save=True, **mode)
                    old = parent_call(bool(mc), fwd, mode)
                    (_compare_int8 if int8 else _compare)(
                        f"{kernel} parent against tree", old[0], tree[0], tol)
                    del tree, old
                    runs = (lambda: parent_call(bool(mc), fwd, mode),
                            lambda: ours_fn(*fwd, save=True, **mode))
                    p1, t1, t2, p2 = (_cuda_ms(runs[i], 3, 1)
                                      for i in (0, 1, 1, 0))
                    form = "[int8]" if int8 else ""
                    print(f"[wide] in turns {kernel}{form} save=True units "
                          f"{d_model} heads {heads} (dh {dh}, 2F "
                          f"{w_r.shape[2]}) B={b} T={t} M={mc}, p=0.1 "
                          f"{dtype}: parent {p1:.4f} / {p2:.4f} ms, tree "
                          f"{t1:.4f} / {t2:.4f} ms, "
                          f"{(p1 + p2) / (t1 + t2):.2f}x faster [{card}]",
                          flush=True)
                if mc:  # #6, float form only, as in the reference
                    mem = randn(3, r_blocks, b, d_model, t, dtype=dtype)
                    wk, wv = (randn(d_model, heads, dh, std=0.05)
                              for _ in range(2))
                    wk2, wv2 = (w.reshape(d_model, heads * dh).to(dtype)
                                .contiguous() for w in (wk, wv))
                    drop = dict(seed=DROPOUT_SEED, dropout_p=DROPOUT_P)
                    tail = (k_win, v_win, w_r, trig_a, psi, mask, reset,
                            scale)
                    args = (q, rwbs, rrbs, mem, wk2, wv2, *tail)
                    drop_args = prng.kernel_args(DROPOUT_SEED, DROPOUT_P,
                                                 None)
                    tree = fa.rel_attention_proj_fwd(
                        q, rwbs, rrbs, mem, 2, wk, wv, *tail, save=True,
                        **drop)
                    old = parent_proj(args, drop_args)
                    _compare("rel_attention_proj_fwd parent against tree",
                             old[0], tree[0], tol)
                    del tree, old
                    runs = (lambda: parent_proj(args, drop_args),
                            lambda: fa.rel_attention_proj_fwd(
                                q, rwbs, rrbs, mem, 2, wk, wv, *tail,
                                save=True, **drop))
                    p1, t1, t2, p2 = (_cuda_ms(runs[i], 3, 1)
                                      for i in (0, 1, 1, 0))
                    print(f"[wide] in turns rel_attention_proj_fwd save=True "
                          f"units {d_model} heads {heads} (dh {dh}, 2F "
                          f"{w_r.shape[2]}) B={b} T={t} M={mc}, p=0.1 "
                          f"{dtype}: parent {p1:.4f} / {p2:.4f} ms, tree "
                          f"{t1:.4f} / {t2:.4f} ms, "
                          f"{(p1 + p2) / (t1 + t2):.2f}x faster [{card}]",
                          flush=True)
                    del mem, args, runs
            del q, k_win, v_win, k_mem, v_mem
            torch.cuda.empty_cache()


def wide_phase(data_dir: Path, work_dir: Path, card: str,
               widths=WIDE_WIDTHS) -> dict:
    """``[wide]``: the train CLI at ``TrainConfig()`` with the model at each
    of ``widths`` (6 layers), ``WIDE_STEPS`` steps: in the exact mode
    (``--precise_bd``) at dropout 0 on the kernel path in f32 and bf16,
    each step's ``nll_sum`` and ``grad_norm`` held against the unfused path
    (``--set model.attn_impl=xla``, which launches no kernel) from the same
    weights and batches: f32 against the unfused f32 run, bf16 against it
    too (the f32 trajectory), within rtol ``WIDE_TOL``, the relative
    distances to the unfused bf16 run printed beside; then in the fast mode (the CLI's default) at
    ``ModelConfig()``'s dropout 0.1, f32 and bf16, the losses finite.  Every
    run prints ms/step and peak memory (``[train]`` lines); none evaluates
    inside the run, and its final test pass runs over a memory of 256.
    Returns the kernel launches of the kernel-path runs."""
    import torch

    from commu_tpu_torch.ops import _build

    launches = {name: 0 for name in _build.LAUNCHES}
    errors = []
    for units, heads, inner in widths:
        # no eval inside the run, and final_test's pass over a memory of
        # 256: the steps are what this phase measures
        width = ("--set", f"model.units={units}", "--set",
                 f"model.num_heads={heads}", "--set",
                 f"model.inner_size={inner}", "--set",
                 "train.eval_interval=1000", "--set",
                 "evaluate.mem_length=256")
        tag = f"units{units}_h{heads}"
        kernel_rec, unfused_rec = {}, {}
        runs = [train(data_dir, work_dir / f"{tag}_exact", card, False,
                      ("float32", "bfloat16"), WIDE_STEPS, width,
                      records=kernel_rec)]
        unfused, _ = train(data_dir, work_dir / f"{tag}_unfused", card, False,
                           ("float32", "bfloat16"), WIDE_STEPS,
                           width + ("--set", "model.attn_impl=xla"), (),
                           tuple(_build.LAUNCHES), records=unfused_rec)
        if any(unfused.values()):
            errors.append(f"{tag}: the unfused runs launched {unfused}")
        for dtype in ("float32", "bfloat16"):
            for i, (k, u, p) in enumerate(zip(kernel_rec[dtype],
                                              unfused_rec[dtype],
                                              unfused_rec["float32"])):
                rel = (abs(u[1] - k[1]) / abs(k[1]),
                       abs(u[3] - k[3]) / abs(k[3]))
                tol = WIDE_TOL[dtype]
                print(f"[wide] {tag} exact dropout 0 {dtype} step {i}: "
                      f"nll_sum kernel {k[1]!r} unfused {u[1]!r} (rel "
                      f"{rel[0]:.3e}), grad_norm {k[3]!r} vs {u[3]!r} (rel "
                      f"{rel[1]:.3e}), rtol {tol} [{card}]")
                if k[2] != u[2] or (dtype == "float32" and max(rel) > tol):
                    errors.append(f"{tag} {dtype} step {i}: rel {rel}")
                if dtype == "float32":
                    continue
                # bf16: each path against the f32 trajectory (held above)
                near = [(abs(x[1] - p[1]) / abs(p[1]),
                         abs(x[3] - p[3]) / abs(p[3])) for x in (k, u)]
                print(f"[wide] {tag} exact dropout 0 bfloat16 step {i} "
                      f"against the unfused f32 step: kernel nll_sum rel "
                      f"{near[0][0]:.3e} grad_norm rel {near[0][1]:.3e}; "
                      f"unfused nll_sum rel {near[1][0]:.3e} grad_norm rel "
                      f"{near[1][1]:.3e}; rtol {tol} on the kernel path's "
                      f"[{card}]")
                if max(near[0]) > tol:
                    errors.append(f"{tag} bfloat16 step {i}: rel to the f32 "
                                  f"trajectory {near[0]}")
        runs.append(train(data_dir, work_dir / f"{tag}_fast", card, True,
                          ("float32", "bfloat16"), WIDE_STEPS, width,
                          FAST_TRAIN_KERNELS, FAST_UNWANTED, None,
                          {"rel_attention_mem_bwd[int8]": 6,
                           "ffn_block_bwd[bits8]": 6}, False))
        for run, _ in runs:
            for name, n in run.items():
                launches[name] += n
        torch.cuda.empty_cache()
    if errors:
        raise AssertionError("wide: " + "; ".join(errors))
    return launches


def _window_grads(data_dir: Path, cfg, dtype, windows: int, device,
                  reference=None):
    """The train step's first ``windows`` windows from the seeded weights
    with the weights left alone (the optimizer and the scheduler a no-op,
    the clip off, so each window's gradient is the step's whole gradient at
    the same weights); the memory advances as in ``Trainer.train``.  Without
    ``reference``: per window (nll_sum, the gradients in f64 on the host).
    With one (those of another run): per window (nll_sum, {parameter:
    (|g - ref|, |ref|, |g|)}) in f64."""
    import types

    import torch

    from commu_tpu_torch.training import loop
    from commu_tpu_torch.training.step import make_train_step

    cfg = cfg.replace(train=dataclasses.replace(cfg.train,
                                                clip=float("inf")))
    trainer = loop.Trainer(str(data_dir), cfg, device=device,
                           model_dtype=dtype)
    model = trainer.model.train()
    frozen = types.SimpleNamespace(
        zero_grad=lambda set_to_none=True: model.zero_grad(set_to_none=True),
        step=lambda: None, last_epoch=0)
    step = make_train_step(model, frozen, frozen, cfg)
    tcfg, mcfg = cfg.train, cfg.model
    if model.attn_impl == "xla":
        memory = loop.init_train_memory(
            mcfg.num_layers, tcfg.batch_size, tcfg.mem_length, mcfg.units,
            loop.resolve_physical_chunks(cfg), dtype=dtype, device=device)
    else:
        memory = loop.init_memory(mcfg.num_layers, tcfg.batch_size,
                                  tcfg.mem_length, mcfg.units, dtype=dtype,
                                  block_len=tcfg.tgt_length, device=device)
    it = trainer.dataset.train_iterator(tcfg.batch_size, tcfg.tgt_length,
                                        shuffle=True, seed=tcfg.seed)
    out = []
    for i, batch in zip(range(windows), it):
        memory, metrics = step(memory, trainer._feed(batch.inputs),
                               trainer._feed(batch.targets),
                               trainer._feed(batch.reset))
        grads = {n: p.grad.double() for n, p in model.named_parameters()}
        if reference is None:
            grads = {n: g.cpu() for n, g in grads.items()}
        else:
            ref = reference[i][1]
            grads = {n: (float((g - ref[n].to(g.device)).norm()),
                         float(ref[n].norm()), float(g.norm()))
                     for n, g in grads.items()}
        out.append((float(metrics["nll_sum"]), grads))
    del trainer, model, memory, step
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


def _param_group(name: str) -> str:
    """A parameter's name with its layer index left out."""
    return ".".join("*" if part.isdigit() else part
                    for part in name.split("."))


def _unfused_ops(attn, x, mem, pos_emb, mask, r_w_bias, r_r_bias, dtype):
    """Layer ``attn``'s unfused attention (``forward_unfused`` at dropout 0)
    on the given inputs with its products in ``dtype``, returning each
    operation's result: ac, bd (shifted), score, probs, vec, out (the o
    projection) and the layer's output y; and the score and probs as the
    path took them before it matched the reference's jitted step, the sum
    ac + bd rounded to ``dtype`` (``score_dtype_sum``, ``probs_dtype_sum``;
    the same as score and probs in f32 and f64)."""
    import torch
    import torch.nn.functional as F

    from commu_tpu_torch.models.transformer_xl import _layer_norm
    from commu_tpu_torch.ops.rel_attention import rel_shift

    b, t, d = x.shape
    h = attn.cfg.num_heads
    dh = d // h
    hd = h * dh
    x = x.to(dtype)
    w_qkv = attn.qkv_net.weight.to(dtype)
    cat = torch.cat([mem.to(dtype), x], dim=1)
    klen = cat.shape[1]
    q = F.linear(x, w_qkv[:hd]).reshape(b, t, h, dh)
    kv = F.linear(cat, w_qkv[hd:])
    k = kv[..., :hd].reshape(b, klen, h, dh)
    v = kv[..., hd:].reshape(b, klen, h, dh)
    r = F.linear(pos_emb.to(dtype), attn.r_net.weight.to(dtype)).reshape(
        klen, h, dh)
    ac = torch.einsum("bihd,bjhd->bhij", q + r_w_bias.to(dtype), k)
    bd = rel_shift(torch.einsum("bihd,jhd->bhij", q + r_r_bias.to(dtype), r))
    # the path's scores: ac and bd in the compute dtype, their sum widened
    # (f64 stays f64); then the sum rounded to the compute dtype first
    wide = torch.float64 if dtype == torch.float64 else torch.float32
    score = (ac.to(wide) + bd.to(wide)) * (1.0 / dh ** 0.5)
    probs = torch.softmax(score.masked_fill(mask, float("-inf")), dim=-1)
    score_sum = (ac + bd).to(wide) * (1.0 / dh ** 0.5)
    probs_sum = torch.softmax(score_sum.masked_fill(mask, float("-inf")),
                              dim=-1)
    vec = torch.einsum("bhij,bjhd->bihd", probs.to(dtype), v)
    out = F.linear(vec.reshape(b, t, hd), attn.o_net.weight.to(dtype))
    # in f64 the f32 LayerNorm parameters promote to f64
    y = _layer_norm(x.to(wide) + out.to(wide), attn.layer_norm)
    return {"ac": ac, "bd": bd, "score": score, "probs": probs, "vec": vec,
            "out": out, "y": y, "score_dtype_sum": score_sum,
            "probs_dtype_sum": probs_sum}


C2_STEPS = (0, 3)


def c2_reading(data_dir: Path, work_dir: Path, card: str,
               widths=((500, 10, 1000), (1536, 12, 6144))) -> None:
    """``[c2]``: where the unfused path loses precision in bf16.  Runs
    ``[wide]``'s unfused bf16 run (the train CLI, ``--precise_bd``, dropout
    0, ``--set model.attn_impl=xla``, 4 steps at ``TrainConfig()``) at each
    of ``widths`` (default ``ModelConfig()``'s and units 1536 / 12 heads),
    and at steps ``C2_STEPS`` takes layer 0's inputs on the first chunk
    (the layer input, its memory rows, the sinusoid, the mask and the
    weights of that moment) and runs its operations again twice from them:
    as the path does in bf16, and in f64.  One line per operation: the bf16
    result's max |err| / max |ref| and rms err / rms ref against f64."""
    import torch

    from commu_tpu_torch import train as train_cli
    from commu_tpu_torch.models.transformer_xl import RelMultiHeadAttention
    from commu_tpu_torch.training import loop

    make_step = loop.make_train_step
    unfused = RelMultiHeadAttention.forward_unfused
    state = {"step": -1, "layer0": None, "seen": -1}

    def counted(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def run(*a):
            state["step"] += 1
            return step(*a)
        return run

    def hooked(self, x, mem, pos_emb, mask, r_w_bias, r_r_bias,
               generator=None):
        if state["layer0"] is None:
            state["layer0"] = self
        if (self is state["layer0"] and state["step"] in C2_STEPS
                and state["seen"] < state["step"]):
            state["seen"] = state["step"]
            with torch.no_grad():
                ours = _unfused_ops(self, x, mem, pos_emb, mask, r_w_bias,
                                    r_r_bias, x.dtype)
                ref = _unfused_ops(self, x.double(), mem.double(),
                                   pos_emb.double(), mask, r_w_bias.double(),
                                   r_r_bias.double(), torch.float64)
                for name, r in ref.items():
                    o = ours[name].double()
                    err = o - r
                    top = float(r.abs().max())
                    rms = float(r.pow(2).mean().sqrt())
                    print(f"[c2] {state['tag']} bf16 step {state['step']} "
                          f"layer 0 {name} {tuple(r.shape)}: max|err|/max|ref| "
                          f"{float(err.abs().max()) / top:.3e}, rms err / rms "
                          f"ref {float(err.pow(2).mean().sqrt()) / rms:.3e} "
                          f"(max|ref| {top:.3e}) [{card}]")
                del ours, ref
                torch.cuda.empty_cache()
        return unfused(self, x, mem, pos_emb, mask, r_w_bias, r_r_bias,
                       generator)

    loop.make_train_step = counted
    RelMultiHeadAttention.forward_unfused = hooked
    try:
        for units, heads, inner in widths:
            state.update(step=-1, layer0=None, seen=-1,
                         tag=f"units {units} heads {heads} (dh "
                             f"{units // heads})")
            train_cli.main([
                "--data_dir", str(data_dir), "--work_dir",
                str(work_dir / f"units{units}_h{heads}"), "--dtype",
                "bfloat16", "--max_step", str(WIDE_STEPS), "--precise_bd",
                "--set", "model.dropout=0.0", "--set",
                "model.attention_dropout=0.0", "--set",
                f"model.units={units}", "--set", f"model.num_heads={heads}",
                "--set", f"model.inner_size={inner}", "--set",
                "model.attn_impl=xla", "--set", "train.log_interval=4",
                "--set", "train.eval_interval=1000", "--set",
                "evaluate.mem_length=256"])
            if state["seen"] != C2_STEPS[-1]:
                raise AssertionError(f"c2: layer 0 seen at step "
                                     f"{state['seen']}")
    finally:
        loop.make_train_step = make_step
        RelMultiHeadAttention.forward_unfused = unfused


def grad_attribution(data_dir: Path, card: str, widths=None,
                     device="cuda", windows: int = 2) -> dict:
    """``[grads]``: where the kernel path's gradient departs from the
    unfused path's, at ``TrainConfig()`` and dropout 0 (``widths``: (units,
    heads, inner) each, default ``ModelConfig()``'s and ``WIDE_WIDTHS``).
    Both paths, f32 and bf16, and the unfused path in f64 run the step's
    first ``windows`` windows from the same weights (``_window_grads``:
    window 0 over the empty memory, window 1 over the first window's rows).
    Per window it prints each run's ``nll_sum`` and gradient norm against
    f64 (signed: a negative one is a norm short of f64's), then for the
    eight parameter groups (the layers summed) that hold most of the
    kernel path's norm gap ||g - g64|| / ||g64|| and their share of it,
    then the first of them by layer.  Returns {(units, heads, dtype name,
    path): the largest |grad_norm - f64's| / f64's over the windows}."""
    import torch

    from commu_tpu_torch.config import ModelConfig, TrainingConfig

    if widths is None:
        base = ModelConfig()
        widths = ((base.units, base.num_heads, base.inner_size),) \
            + WIDE_WIDTHS
    readings = {}
    for units, heads, inner in widths:
        cfg = TrainingConfig()
        cfg = cfg.replace(model=dataclasses.replace(
            cfg.model, units=units, num_heads=heads, inner_size=inner,
            dropout=0.0, attention_dropout=0.0))
        if device == "cpu":  # the parity run of this function
            cfg = cfg.replace(train=dataclasses.replace(
                cfg.train, batch_size=8, tgt_length=16, mem_length=32),
                model=dataclasses.replace(cfg.model, num_layers=2))
        unfused = cfg.replace(model=dataclasses.replace(cfg.model,
                                                        attn_impl="xla"))
        ref = _window_grads(data_dir, unfused, torch.float64, windows, device)
        tag = f"units {units} heads {heads} (dh {units // heads})"
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            runs = {path: _window_grads(data_dir, c, dtype, windows, device,
                                        ref)
                    for path, c in (("kernel", cfg), ("unfused", unfused))}
            for w in range(windows):
                norm64 = sum(float(g.norm()) ** 2
                             for g in ref[w][1].values()) ** 0.5
                parts = []
                for path, run in runs.items():
                    nll, stats = run[w]
                    norm = sum(s[2] ** 2 for s in stats.values()) ** 0.5
                    dist = sum(s[0] ** 2 for s in stats.values()) ** 0.5
                    rel = (norm - norm64) / norm64
                    key = (units, heads, dname, path)
                    readings[key] = max(readings.get(key, 0.0), abs(rel))
                    parts.append(
                        f"{path} nll_sum {(nll - ref[w][0]) / ref[w][0]:+.3e}"
                        f" grad_norm {rel:+.3e} ||g - g64||/||g64|| "
                        f"{dist / norm64:.3e}")
                print(f"[grads] {tag} {dname} window {w} against f64 "
                      f"(nll_sum {ref[w][0]!r}, grad_norm {norm64!r}): "
                      + "; ".join(parts) + f" [{card}]")
                # per group: ||g - g64|| / ||g64||, and its share of the
                # global norm's relative gap, (|g|^2 - |g64|^2) / 2 |g64|^2
                # summed over its tensors (the shares add up to the gap)
                groups = {}
                for path, run in runs.items():
                    for name, (d, r, n) in run[w][1].items():
                        acc = groups.setdefault(_param_group(name),
                                                {"ref": 0.0})
                        acc[path] = acc.get(path, 0.0) + d * d
                        acc[path + " gap"] = acc.get(path + " gap", 0.0) \
                            + (n * n - r * r) / (2 * norm64 ** 2)
                        if path == "kernel":
                            acc["ref"] += r * r
                worst = sorted(groups.items(),
                               key=lambda kv: -abs(kv[1]["kernel gap"]))
                for group, acc in worst[:8]:
                    print(f"[grads]   {dname} window {w} {group}: "
                          f"||g - g64||/||g64|| kernel "
                          f"{(acc['kernel'] / acc['ref']) ** 0.5:.3e} unfused "
                          f"{(acc['unfused'] / acc['ref']) ** 0.5:.3e}; share "
                          f"of the grad_norm gap kernel "
                          f"{acc['kernel gap']:+.3e} unfused "
                          f"{acc['unfused gap']:+.3e}")
                top = worst[0][0]
                unf = runs["unfused"][w][1]
                layers = [(name, d / r, unf[name][0] / r)
                          for name, (d, r, _) in runs["kernel"][w][1].items()
                          if _param_group(name) == top and r > 0]
                print(f"[grads]   {dname} window {w} {top} by layer (kernel,"
                      " unfused): " + ", ".join(f"{n} {k:.2e}/{u:.2e}"
                                                for n, k, u in layers))
        del ref
    return readings


# ---- the reference's five opt-in levers of its attention kernels ---------

LEVER_ENV = {"clamp": {"COMMU_SOFTMAX": "clamp"},
             "defer": {"COMMU_DEFER_NORM": "1"},
             "hoist": {"COMMU_SCALE_HOIST": "1"},
             "int8_dq": {"COMMU_INT8_DQ": "1"},
             "int8_dk": {"COMMU_INT8_DK": "1"}}
LEVER_STEPS = 20
# what each lever's fast-mode train run over the memory launches in place
# of the fast mode's attention form, and that form
LEVER_FORMS = {"clamp": ("rel_attention_mem_fwd[clamp]",
                         "rel_attention_mem_fwd[int8]"),
               "defer": ("rel_attention_mem_fwd[after]",
                         "rel_attention_mem_fwd[int8]"),
               "hoist": ("rel_attention_mem_fwd[after]",
                         "rel_attention_mem_fwd[int8]"),
               "int8_dq": ("rel_attention_mem_bwd[int8_dq]",
                           "rel_attention_mem_bwd[int8]"),
               "int8_dk": ("rel_attention_mem_bwd[int8_dk]",
                           "rel_attention_mem_bwd[int8]")}
# the reference's bounds on the int8 dq and dk (tests/test_fused_attention.py
# :352): every gradient within 5% of its largest magnitude, correlated
LEVER_GRAD_REL, LEVER_GRAD_CORR = 0.05, 0.99


def _lever_sets():
    from commu_tpu_torch.ops import fused_attention as fa

    fwd = {"clamp": fa.Levers(clamp=True), "defer": fa.Levers(defer=True),
           "hoist": fa.Levers(hoist=True),
           "clamp+defer": fa.Levers(clamp=True, defer=True)}
    bwd = {"int8_dq": fa.Levers(int8_dq=True),
           "int8_dk": fa.Levers(int8_dk=True),
           "int8_dq+dk": fa.Levers(int8_dq=True, int8_dk=True)}
    return fwd, bwd


def _in_turns(default, form, iters=5) -> tuple:
    """(default ms, form ms): default, form, form, default on one card."""
    a1, b1, b2, a2 = (_cuda_ms(fn, iters, 1)
                      for fn in (default, form, form, default))
    return (a1 + a2) / 2, (b1 + b2) / 2


def _past_the_clamp(fwd, k_at: int, b_row: int, row: int = 5) -> tuple:
    """A forward's operands ``fwd`` with scores past the clamp: q 40 times
    larger, so that the scores' spread is about 40 and several in a hundred
    pass 60; and one row whose live scores all lie below -110, where exp
    underflows to 0 in f32: batch row ``b_row`` (a reset row: its memory
    keys are masked), head 0, query ``row``, against window keys (``fwd
    [k_at]``) that share a component of 1 in every head dim, the query -30
    in each (its content score about -30 sqrt(dh))."""
    fwd = list(fwd)
    q = fwd[0].float() * 40.0
    q[b_row, 0, :, row] = -30.0
    k = fwd[k_at].clone()
    k[b_row, 0] = (1.0 + 0.1 * k[b_row, 0].float()).to(k.dtype)
    fwd[0], fwd[k_at] = q.to(fwd[0].dtype), k
    return tuple(fwd)


def _out_s_lse(res) -> tuple:
    """The projecting forward's out, S and lse (of out, K, V, S, lse)."""
    return res[0], res[3], res[4]


def _check_past_the_clamp(what, kernel, plain, lv, mode, fast, tol, b_row,
                          row=5) -> str:
    """A clamped form (``kernel``: its out, S and lse) on ``_past_the_clamp``'s
    operands against its twin (``plain``) under the lever ``lv``: S and lse
    as the sums are held (``_compare_scaled``; the int8 rules in the fast
    mode): each score sums terms 40 times the unit-scale operands', so one
    whose terms cancel carries their error (1.2e-3 near 0 at the training
    shape), and a row's lse its scores' (5.5e-4); out within
    ``tol`` of the twin's softmax and P v over the form's own S (exp turns
    that score error into a relative error of out; its distance to the
    twin's out is printed); S
    at most 60 and at 60 in more than 1 in 100 live scores; the
    underflowing row's out zeros and its lse log(1e-30); and out more than
    100 tol from the default form's on the same inputs (a form that kept
    the row maximum, or lost the clamp or the 1e-30 guard, fails).  Returns
    the line's text."""
    import math

    import torch

    from commu_tpu_torch.ops import fused_attention as fa

    ours, ref = kernel(levers=lv, **mode), plain(levers=lv, **mode)
    default = kernel(**mode)
    torch.cuda.synchronize()
    live = ref[1] > -1e30
    if not torch.equal(live, ours[1] > -1e30):
        raise AssertionError(f"{what}: masks differ")
    n_live = float(live.sum())
    low = float(ref[1][b_row, 0, row][live[b_row, 0, row]].max())
    share = float((ref[1] == 60.0).sum()) / n_live
    if not (low < -110.0 and share > 0.01):
        raise AssertionError(f"{what}: the data miss the clamp's ends (row "
                             f"max {low:.1f}, {share:.4f} at 60)")
    scores = fa._scores_plain
    fa._scores_plain = lambda *args, **kwargs: ours[1]
    try:
        on_ours = plain(levers=lv, **mode)[0]
    finally:
        fa._scores_plain = scores
    err = max(_compare(f"{what} out (over its own S)", ours[0], on_ours, tol),
              _compare_int8_rows(f"{what} S", ours[1], ref[1], tol) if fast
              else _compare_scaled(f"{what} S", ours[1][live], ref[1][live],
                                   tol),
              _compare_int8(f"{what} lse", ours[2], ref[2], tol) if fast
              else _compare_scaled(f"{what} lse", ours[2], ref[2], tol))
    direct = float((ours[0].float() - ref[0].float()).abs().max())
    ours_share = float((ours[1] == 60.0).sum()) / n_live
    zeros = bool((ours[0][b_row, 0, :, row].float() == 0).all())
    lse_row = float(ours[2][b_row, 0, row])
    dist = float((ours[0].float() - default[0].float()).abs().max())
    if (float(ours[1].max()) > 60.0 or ours_share <= 0.01 or not zeros
            or abs(lse_row - math.log(1e-30)) > 1e-4
            or not bool(torch.isfinite(ours[2]).all()) or dist <= 100 * tol):
        raise AssertionError(
            f"{what}: max S {float(ours[1].max()):.3f}, {ours_share:.4f} at "
            f"60, underflowing row zeros {zeros}, its lse {lse_row:.5f}, "
            f"{dist:.3e} from the default form's out (> {100 * tol})")
    return (f"max_abs_err={err:.3e} ({tol}; out {direct:.3e} from the "
            f"twin's over the twin's S), {100 * share:.1f}% of the live "
            f"scores at 60, a row below {low:.1f}: out 0, lse {lse_row:.4f}; "
            f"{dist:.3f} from the default form's out (> {100 * tol:g})")


def check_lever_kernels(card: str, b: int = 256, t: int = 128) -> dict:
    """Phase 1g: the lever forms (``ops.fused_attention.Levers``) against
    their twins under the same lever, at ``ModelConfig()`` (D 500, 10
    heads) and at units 1536 / 12 heads: at the training shape (B = 256,
    T = 128, a full ring of 8 slabs of 128) and without memory (the T0
    shape), at p = 0.1, in the exact mode (16-bit masks) and the fast mode
    (8-bit masks, the int8 BD forward, the int8 dphi backward; psi under
    its dropout): #2 and #1 under clamp, defer, hoist and clamp with
    defer; #6 under the same (exact mode only); #4 and #3 under int8 dq,
    int8 dk and both.  The forwards within the stated tolerance of their
    twins (an int8 form within ``INT8_TOL``), the clamped forms' S at most
    60, and the clamped forms again where the clamp acts
    (``_past_the_clamp``, ``_check_past_the_clamp``); the backwards within
    ``INT8_TOL``, dv and dWv equal to the default
    form's bit for bit and the quantised gradients moved.  Then #2's forms
    at the eval shape (B = 10, M = 2048, no dropout) and #1's at the serving
    prefill (G = 8, T = 11).  ``[levers]`` lines: each check, and each
    form's ms beside its default form's at the training shape, in turns.
    Returns the rows of ``LEVER_ROWS`` (f32, exact mode, ModelConfig())."""
    import torch

    from commu_tpu_torch.ops import _build
    from commu_tpu_torch.ops import fused_attention as fa
    from commu_tpu_torch.ops import prng

    _build.lever_library()  # built beside the main library (main)
    # the int8 dq and dk kernels' registers and spills, as ptxas reported
    import re

    source, name = None, None
    for line in (_build.BUILD_DIR / "build_levers.log").read_text() \
            .splitlines():
        if " -c -o " in line:
            source = Path(line.split()[-1]).name
        elif "Compiling entry function" in line:
            name = re.search(r"'(\S+)'", line).group(1)
        elif name and re.search("d[qk]_int8_kernel", name) and (
                "Used" in line or "spill" in line):
            short = _kernel_name(name)
            tail = name[name.find(short) + len(short):]
            kind = "f32" if tail.startswith("If") else "bf16"
            dh = re.search(r"Li(\d+)E", tail)
            print(f"[ptxas] levers {source} {short}<{kind}, dh "
                  f"<= {dh.group(1) if dh else '?'}>: {line.split(':', 1)[-1].strip()}")
    dev = torch.device("cuda")
    fwd_levers, bwd_levers = _lever_sets()
    rows = dict(LEVER_ROWS)
    results = {}
    r_blocks, streams = 8, 3
    for d_model, heads in ((500, 10), (1536, 12)):
        wide = d_model != 500
        dh = d_model // heads
        scale = 1.0 / dh ** 0.5
        gen = torch.Generator(device=dev).manual_seed(33)
        width = f"D={d_model}/{heads}"

        def randn(*shape, std=1.0, dtype=torch.float32):
            return (torch.randn(shape, generator=gen, device=dev)
                    * std).to(dtype)

        for dtype, tol in ((torch.float32, F32_TOL),
                           (torch.bfloat16, BF16_TOL)):
            dt = str(dtype).split(".")[-1]
            q, k_win, v_win, dout = (randn(b, heads, dh, t, dtype=dtype)
                                     for _ in range(4))
            w_r = fa.pack_r_kernel(randn(d_model, d_model, std=0.05),
                                   heads).to(dtype)
            f2 = w_r.shape[2]
            rwbs, rrbs = fa._scaled_biases(randn(heads, dh, std=0.1),
                                           randn(heads, dh, std=0.1), scale,
                                           dtype)
            reset = (torch.arange(b, device=dev) % 50 == 7).int()
            for m_cap in (r_blocks * t, 0):
                shape = f"B={b} T={t} M={m_cap} {width}"
                k_len = m_cap + t
                head = 256 if m_cap else 0
                psi = fa.ring_psi(fa.key_trig_basis(k_len, d_model, dtype,
                                                    dev), t, m_cap, head)
                keep = prng.keep_mask(DROPOUT_SEED + 3, tuple(psi.shape),
                                      DROPOUT_P, device=dev, bits=16)
                psi = torch.where(keep, psi / torch.tensor(
                    1.0 - DROPOUT_P, dtype=dtype), 0).to(dtype)
                trig_a = fa.query_trig_table(t, m_cap, d_model, dtype, dev)
                mask = fa.build_mask_bias(t, m_cap, m_cap, head, False,
                                          device=dev)
                pairs, mem_cols = _live(mask, reset, m_cap)
                # out, S and lse, written once
                out_bytes = _nbytes(q) + 4 * b * heads * t * (k_len + 1)
                if m_cap:
                    mem = randn(streams, r_blocks, b, d_model, t, dtype=dtype)
                    wk, wv = (randn(d_model, heads, dh, std=0.05)
                              for _ in range(2))
                    k_mem, v_mem = fa.project_mem_kv(mem, 2, wk, wv)
                    fwd = (q, rwbs, rrbs, k_mem, k_win, v_mem, v_win, w_r,
                           trig_a, psi, mask, reset, scale)
                    fwd_k, fwd_p = (fa.rel_attention_mem_fwd,
                                    fa.rel_attention_mem_fwd_plain)
                    bwd_k, bwd_p = (fa.rel_attention_mem_bwd,
                                    fa.rel_attention_mem_bwd_plain)
                    kernel = "rel_attention_mem"
                    moved = {"int8_dq": (0,), "int8_dk": (1, 3)}
                else:
                    fwd = (q, rwbs, rrbs, k_win, v_win, w_r, trig_a, psi,
                           mask, reset, scale)
                    fwd_k, fwd_p = (fa.rel_attention_fwd,
                                    fa.rel_attention_fwd_plain)
                    bwd_k, bwd_p = fa.rel_attention_bwd, fa.rel_attention_bwd_plain
                    kernel = "rel_attention"
                    moved = {"int8_dq": (0,), "int8_dk": (1,)}
                for fast in (False, True):
                    mode_name = "fast" if fast else "exact"
                    drop = dict(seed=DROPOUT_SEED, dropout_p=DROPOUT_P,
                                bits=8 if fast else 16)
                    mode = dict(drop, psi_q=fa.quantize_psi_int8(psi)
                                if fast else None)
                    compare = _compare_int8 if fast else _compare
                    for lever, lv in fwd_levers.items():
                        form = f"{kernel}_fwd[{fa.SOFT_TAGS[lv.soft]}]"
                        ours = fwd_k(*fwd, save=True, levers=lv, **mode)
                        ref = fwd_p(*fwd, save=True, levers=lv, **mode)
                        live = ref[1] > -1e30
                        if not torch.equal(live, ours[1] > -1e30):
                            raise AssertionError(f"{form} {lever}: masks "
                                                 "differ")
                        if lv.clamp and float(ours[1].max()) > 60.0:
                            raise AssertionError(f"{form}: S past the clamp")
                        what = f"{form} ({lever}, {mode_name})"
                        err = max(compare(f"{what} out", ours[0], ref[0],
                                          tol),
                                  _compare_int8_rows(f"{what} S", ours[1],
                                                     ref[1], tol) if fast
                                  else compare(f"{what} S", ours[1][live],
                                               ref[1][live], tol),
                                  compare(f"{what} lse", ours[2], ref[2],
                                          tol))
                        del ours, ref, live
                        name = f"{form}" if (lever != "hoist" and not fast
                                             and not wide) else None
                        if name not in rows:
                            name = None
                        _report_kernel(
                            results, card, name, f"[levers] {what}", shape,
                            dtype, err, tol,
                            lambda: fwd_k(*fwd, save=True, levers=lv, **mode),
                            lambda: fwd_p(*fwd, save=True, levers=lv, **mode),
                            1, nbytes=_nbytes(*fwd[:-1]) + out_bytes
                            if name else 0,
                            **_attention_fwd_ops(dtype, b, heads, dh, t, f2,
                                                 pairs))
                    # the clamp where it acts: scores past 60, a row that
                    # underflows (batch row 7, a reset row)
                    stressed = _past_the_clamp(fwd, 4 if m_cap else 3, 7)
                    for lever in ("clamp", "clamp+defer"):
                        lv = fwd_levers[lever]
                        line = _check_past_the_clamp(
                            f"{kernel}_fwd[{fa.SOFT_TAGS[lv.soft]}] "
                            f"({lever}, {mode_name})",
                            lambda **m: fwd_k(*stressed, save=True, **m),
                            lambda **m: fwd_p(*stressed, save=True, **m),
                            lv, mode, fast, tol, 7)
                        print(f"[levers] past the clamp {kernel}_fwd"
                              f"[{fa.SOFT_TAGS[lv.soft]}] ({lever}, "
                              f"{mode_name}) {shape} {dt}: {line} [{card}]")
                    if m_cap and not fast:  # #6: no int8 form
                        hd = heads * dh
                        args = (q, rwbs, rrbs, mem, 2, wk, wv, k_win, v_win,
                                *fwd[7:])
                        plain_args = (*args[:5],
                                      wk.reshape(d_model, hd).to(dtype),
                                      wv.reshape(d_model, hd).to(dtype),
                                      *args[7:])
                        for lever, lv in fwd_levers.items():
                            form = ("rel_attention_proj_fwd"
                                    f"[{fa.SOFT_TAGS[lv.soft]}]")
                            ours = fa.rel_attention_proj_fwd(
                                *args, save=True, levers=lv, **drop)
                            ref = fa.rel_attention_proj_fwd_plain(
                                *plain_args, save=True, levers=lv, **drop)
                            live = ref[3] > -1e30
                            what = f"{form} ({lever}, exact)"
                            err = max(
                                _compare(f"{what} out", ours[0], ref[0], tol),
                                _compare(f"{what} S", ours[3][live],
                                         ref[3][live], tol),
                                _compare(f"{what} lse", ours[4], ref[4], tol))
                            del ours, ref, live
                            name = form if (lever == "clamp+defer"
                                            and not wide) else None
                            _report_kernel(
                                results, card, name, f"[levers] {what}",
                                shape, dtype, err, tol,
                                lambda: fa.rel_attention_proj_fwd(
                                    *args, save=True, levers=lv, **drop),
                                lambda: fa.rel_attention_proj_fwd_plain(
                                    *plain_args, save=True, levers=lv,
                                    **drop), 1,
                                nbytes=_nbytes(q, rwbs, rrbs, mem[2], wk, wv,
                                               *fwd[4:5], *fwd[6:-1], k_mem,
                                               v_mem) + out_bytes
                                if name else 0,
                                **_attention_fwd_ops(dtype, b, heads, dh, t,
                                                     f2, pairs))
                            ms = _in_turns(
                                lambda: fa.rel_attention_proj_fwd(
                                    *args, save=True, **drop),
                                lambda: fa.rel_attention_proj_fwd(
                                    *args, save=True, levers=lv, **drop),
                                1 if wide else 5)
                            print(f"[levers] time {form} ({lever}, exact) "
                                  f"{shape} {dt}: default form {ms[0]:.4f} "
                                  f"ms, lever form {ms[1]:.4f} ms "
                                  f"({100 * (ms[1] / ms[0] - 1):+.1f}%) "
                                  f"[{card}]")
                        s_args = (stressed[0], *args[1:7], stressed[4],
                                  *args[8:])
                        s_plain = (stressed[0], *plain_args[1:7],
                                   stressed[4], *plain_args[8:])
                        for lever in ("clamp", "clamp+defer"):
                            lv = fwd_levers[lever]
                            form = ("rel_attention_proj_fwd"
                                    f"[{fa.SOFT_TAGS[lv.soft]}]")
                            line = _check_past_the_clamp(
                                f"{form} ({lever}, exact)",
                                lambda **m: _out_s_lse(
                                    fa.rel_attention_proj_fwd(
                                        *s_args, save=True, **m)),
                                lambda **m: _out_s_lse(
                                    fa.rel_attention_proj_fwd_plain(
                                        *s_plain, save=True, **m)),
                                lv, drop, False, tol, 7)
                            print(f"[levers] past the clamp {form} "
                                  f"({lever}, exact) {shape} {dt}: {line} "
                                  f"[{card}]")
                    del stressed
                    # the backward from the twin's residual
                    res = fwd_p(*fwd, save=True, **mode)
                    if m_cap:
                        bwd = (*fwd[:7], mem, 2, *fwd[7:10], res[1], res[2],
                               res[0], dout, scale)
                    else:
                        bwd = (*fwd[:8], res[1], res[2], res[0], dout, scale)
                    del res
                    default = bwd_k(*bwd, **mode)
                    exact = bwd_p(*bwd, **drop)  # neither int8 product
                    for lever, lv in bwd_levers.items():
                        form = f"{kernel}_bwd[{fa.GRAD_TAGS[lv.int8_grads]}]"
                        what = f"{form} ({mode_name})"
                        ours = bwd_k(*bwd, levers=lv, **mode)
                        twin = bwd_p(*bwd, levers=lv, **mode)
                        quantised = {i for key, idx in moved.items()
                                     if getattr(lv, key) for i in idx}
                        torch.cuda.synchronize()
                        err = 0.0
                        for i, (o, pl) in enumerate(zip(ours, twin)):
                            if i in quantised:
                                # a tie of a quantiser moves a whole column
                                err = max(err, _compare_int8_position(
                                    f"{what} output {i}", o, pl, exact[i],
                                    tol, 2e-2))
                            elif not torch.equal(o, default[i]):
                                raise AssertionError(
                                    f"{what}: output {i} differs from the "
                                    "default form's (the levers quantise "
                                    "only dq and dk)")
                        del twin, ours
                        name = form if (not fast and not wide
                                        and form in rows) else None
                        tensors = [x for x in bwd[:-1]
                                   if isinstance(x, torch.Tensor)]
                        if m_cap:
                            tensors = [mem[2] if x is mem else x
                                       for x in tensors]
                        _report_kernel(
                            results, card, name, f"[levers] {what}", shape,
                            dtype, err, INT8_GRADS_TOL.format(
                                far=max(20 * tol, 2e-2)),
                            lambda: bwd_k(*bwd, levers=lv, **mode),
                            lambda: bwd_p(*bwd, levers=lv, **mode), 1,
                            nbytes=_nbytes(*tensors, *default) if name else 0,
                            **_tensor_core_ops(dtype, _attention_bwd_flops(
                                b, heads, dh, t, f2, d_model, pairs,
                                mem_cols)), flops=0)
                    # each form's time beside the default form's, in turns
                    # (at the wide width once a call and in the exact mode
                    # alone: a launch there takes up to 340 ms)
                    turns = 1 if wide else 5
                    for lever, lv in ({} if wide and fast else
                                      fwd_levers).items():
                        ms = _in_turns(
                            lambda: fwd_k(*fwd, save=True, **mode),
                            lambda: fwd_k(*fwd, save=True, levers=lv, **mode),
                            turns)
                        print(f"[levers] time {kernel}_fwd[{fa.SOFT_TAGS[lv.soft]}] "
                              f"({lever}, {mode_name}) {shape} {dt}: "
                              f"default form {ms[0]:.4f} ms, lever form "
                              f"{ms[1]:.4f} ms ({100 * (ms[1] / ms[0] - 1):+.1f}%) "
                              f"[{card}]")
                    for lever, lv in ({} if wide and fast else
                                      bwd_levers).items():
                        ms = _in_turns(lambda: bwd_k(*bwd, **mode),
                                       lambda: bwd_k(*bwd, levers=lv, **mode),
                                       turns)
                        print(f"[levers] time {kernel}_bwd[{fa.GRAD_TAGS[lv.int8_grads]}] "
                              f"({mode_name}) {shape} {dt}: default form "
                              f"{ms[0]:.4f} ms, lever form {ms[1]:.4f} ms "
                              f"({100 * (ms[1] / ms[0] - 1):+.1f}%) [{card}]")
                    del default, exact, bwd
                del fwd
                if m_cap:
                    del mem, k_mem, v_mem
                torch.cuda.empty_cache()
            # the eval shape (#2) and the serving prefill (#1), no dropout
            for kernel_k, kernel_p, bb, tt, m_cap in (
                    (fa.rel_attention_mem_fwd, fa.rel_attention_mem_fwd_plain,
                     10, t, 2048),
                    (fa.rel_attention_fwd, fa.rel_attention_fwd_plain, 8, 11,
                     0)):
                k_len = m_cap + tt
                qq, kw, vw = (randn(bb, heads, dh, tt, dtype=dtype)
                              for _ in range(3))
                psi = fa.ring_psi(fa.key_trig_basis(k_len, d_model, dtype,
                                                    dev), tt, m_cap, 0)
                trig_a = fa.query_trig_table(tt, m_cap, d_model, dtype, dev)
                mask = fa.build_mask_bias(tt, m_cap, m_cap, 0, True,
                                          device=dev)
                rs = torch.zeros(bb, dtype=torch.int32, device=dev)
                if m_cap:
                    mem = randn(3, m_cap // t, bb, d_model, t, dtype=dtype)
                    wk, wv = (randn(d_model, heads, dh, std=0.05)
                              for _ in range(2))
                    k_mem, v_mem = fa.project_mem_kv(mem, 1, wk, wv)
                    fwd = (qq, rwbs, rrbs, k_mem, kw, v_mem, vw, w_r, trig_a,
                           psi, mask, rs, scale)
                else:
                    fwd = (qq, rwbs, rrbs, kw, vw, w_r, trig_a, psi, mask, rs,
                           scale)
                shape = f"B={bb} T={tt} M={m_cap} {width}"
                for fast in (False, True):
                    extra = dict(psi_q=fa.quantize_psi_int8(psi)) if fast \
                        else {}
                    compare = _compare_int8 if fast else _compare
                    for lever, lv in fwd_levers.items():
                        out = kernel_k(*fwd, levers=lv, **extra)
                        ref = kernel_p(*fwd, levers=lv, **extra)
                        err = compare(f"{lever} {shape}", out, ref, tol)
                        ms = _in_turns(lambda: kernel_k(*fwd, **extra),
                                       lambda: kernel_k(*fwd, levers=lv,
                                                        **extra))
                        print(f"[levers] {'eval' if m_cap else 'serving'} "
                              f"({lever}, {'fast' if fast else 'exact'}) "
                              f"{shape} {dt}: max_abs_err={err:.3e} ({tol}) "
                              f"default form {ms[0]:.4f} ms, lever form "
                              f"{ms[1]:.4f} ms [{card}]")
                del fwd
    return results


def _lever_grads(card: str) -> dict:
    """Step 0's gradients at ``ModelConfig()`` width (dropout 0, f32, B =
    32, T = 128 over a full ring of 1,024 seeded hiddens) with and without
    ``COMMU_INT8_DQ=1`` and ``COMMU_INT8_DK=1``: the loss equal, every
    gradient within ``LEVER_GRAD_REL`` of its largest magnitude of the
    default's and correlated above ``LEVER_GRAD_CORR`` (the reference's
    bounds).  Returns the launches of the lever run."""
    import dataclasses
    import os

    import numpy as np
    import torch

    from commu_tpu_torch.models import (VOCAB_SIZE, ModelConfig, TransformerXL,
                                        memory_from_arrays)
    from commu_tpu_torch.ops import _build
    from commu_tpu_torch.ops.fused_nll import fused_token_nll
    from commu_tpu_torch.training import masked_chunk_loss

    cfg = dataclasses.replace(ModelConfig(), dropout=0.0,
                              attention_dropout=0.0)
    dev = torch.device("cuda")
    model = TransformerXL(VOCAB_SIZE, cfg, dtype=torch.float32)
    model.init_parameters(torch.Generator().manual_seed(0))
    model = model.to(dev)
    b, t, r_blocks = 32, 128, 8
    rng = np.random.default_rng(7)
    hidden = (rng.normal(size=(cfg.num_layers + 1, r_blocks, b, cfg.units, t))
              * 0.5).astype(np.float32)
    inputs, targets = (torch.from_numpy(rng.integers(
        1, VOCAB_SIZE, size=(b, t)).astype(np.int32)).to(dev)
        for _ in range(2))
    reset = torch.zeros(b, dtype=torch.bool, device=dev)

    def grads():
        model.zero_grad(set_to_none=True)
        out, _ = model.forward_train(
            inputs, reset, memory_from_arrays(hidden, r_blocks * t, 0,
                                              device=dev))
        nll = fused_token_nll(out.transpose(1, 2), model.embedding,
                              model.out_bias, targets)
        loss = masked_chunk_loss(nll, targets, 1)[0]
        loss.backward()
        return loss.detach(), {n: p.grad.double()
                               for n, p in model.named_parameters()}

    saved = {k: os.environ.get(k) for k in ("COMMU_INT8_DQ", "COMMU_INT8_DK")}
    try:
        for k in saved:
            os.environ.pop(k, None)
        base_loss, base = grads()
        os.environ.update({k: "1" for k in saved})
        _build.reset_launches()
        loss, lever = grads()
        launches = dict(_build.LAUNCHES)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if not torch.equal(loss, base_loss):
        raise AssertionError(f"int8 dq+dk: loss {loss} != {base_loss}")
    worst, corr_min = 0.0, 1.0
    for name, g0 in base.items():
        g1 = lever[name]
        rel = float((g1 - g0).abs().max() / g0.abs().max().clamp(min=1e-12))
        corr = 1.0
        if g0.numel() > 1 and float(g0.std()) > 0.0:
            corr = float(torch.corrcoef(torch.stack([g0.ravel(),
                                                     g1.ravel()]))[0, 1])
        if not (rel < LEVER_GRAD_REL and corr > LEVER_GRAD_CORR):
            raise AssertionError(f"int8 dq+dk {name}: max |g - g0| / max|g0| "
                                 f"{rel:.3e}, corr {corr:.5f}")
        worst, corr_min = max(worst, rel), min(corr, corr_min)
    if launches["rel_attention_mem_bwd[int8_dq+dk]"] != cfg.num_layers:
        raise AssertionError(f"int8 dq+dk: launches {launches}")
    print(f"[levers] step 0 gradients, ModelConfig() dropout 0 f32, B={b} "
          f"T={t} M={r_blocks * t}, COMMU_INT8_DQ=1 COMMU_INT8_DK=1 against "
          f"the default: loss equal ({float(loss):.6f}), worst max|g - g0| / "
          f"max|g0| {worst:.3e} (< {LEVER_GRAD_REL}), least correlation "
          f"{corr_min:.6f} (> {LEVER_GRAD_CORR}) over {len(base)} "
          f"parameters [{card}]")
    return launches


def levers_phase(data_dir: Path, work_dir: Path, card: str) -> dict:
    """Phase 10b: the five levers through the train CLI at ``TrainConfig()``
    and ``ModelConfig()``: ``LEVER_STEPS`` fast bf16 steps over the memory
    under each lever alone, finite losses, its form launched in place of the
    fast mode's (the forward forms in the eval and test passes too); then
    the step-0 gradients under int8 dq and dk against the default's
    (``_lever_grads``); then 4 fast bf16 steps without memory under all five
    levers (#1's and #3's combined forms), and 4 exact (``--precise_bd``)
    bf16 steps with ``COMMU_PROJ_IN_FWD=1`` under all five (#6's and #4's
    combined forms).  Returns the launches of these runs."""
    launches = {}

    def add(run):
        for name, n in run.items():
            launches[name] = launches.get(name, 0) + n

    for lever, env in LEVER_ENV.items():
        form, replaced = LEVER_FORMS[lever]
        per_step = ({form: 6, "ffn_block_bwd[bits8]": 6}
                    if "bwd" in form else {"ffn_block_bwd[bits8]": 6})
        run, _ = train(data_dir, work_dir / lever, card, True, ("bfloat16",),
                       LEVER_STEPS, (), (form,), (replaced,), env, per_step,
                       False)
        add(run)
    add(_lever_grads(card))
    every = {k: v for env in LEVER_ENV.values() for k, v in env.items()}
    run, _ = train(data_dir, work_dir / "all_m0", card, True, ("bfloat16",), 4,
                   NO_MEMORY, ("rel_attention_fwd[clamp+after]",
                               "rel_attention_bwd[int8_dq+dk]"),
                   ("rel_attention_fwd[int8]", "rel_attention_bwd[int8]"),
                   every, {"rel_attention_bwd[int8_dq+dk]": 6}, False)
    add(run)
    run, _ = train(data_dir, work_dir / "all_proj", card, True, ("bfloat16",),
                   4, (), ("rel_attention_proj_fwd[clamp+after]",
                           "rel_attention_mem_bwd[int8_dq+dk]"),
                   ("rel_attention_proj_fwd", "rel_attention_mem_bwd"),
                   dict(every, COMMU_PROJ_IN_FWD="1"),
                   {"rel_attention_mem_bwd[int8_dq+dk]": 6}, True)
    add(run)
    return launches


def run_recorded_cli(out_path: str, argv, backend=None) -> None:
    """One process of ``[ddp]``: ``commu_tpu_torch.train.main(argv)`` with its
    train step wrapped to synchronize and record each step (host clock,
    ``nll_sum``, ``token_count``, ``grad_norm``), then the peak device
    memory, written to ``out_path`` as JSON.  ``backend``: the process
    group's, in place of the default (gloo lets two ranks share the card:
    NCCL takes one rank a device)."""
    import functools

    import torch

    from commu_tpu_torch import train as train_cli
    from commu_tpu_torch.ops import _build
    from commu_tpu_torch.parallel import multihost
    from commu_tpu_torch.training import loop

    if backend is not None:
        multihost.initialize = functools.partial(multihost.initialize,
                                                 backend=backend)

    make_step = loop.make_train_step
    record = []

    def recorded(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def run(memory, inputs, targets, reset):
            out = step(memory, inputs, targets, reset)
            torch.cuda.synchronize()
            m = out[1]
            record.append([time.perf_counter(), float(m["nll_sum"]),
                           float(m["token_count"]), float(m["grad_norm"])])
            return out
        return run

    loop.make_train_step = recorded
    work = train_cli.main(list(argv))
    Path(out_path).write_text(json.dumps({
        "work_dir": work, "steps": record, "launches": dict(_build.LAUNCHES),
        "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20}))


def _recorded_runs(jobs, timeout=900, backend=None) -> list:
    """Start ``run_recorded_cli`` in one fresh process per (out_path, argv)
    of ``jobs``, all together, over ``backend``; wait for every one, kill
    the rest if one fails or the time runs out, and return their
    records."""
    import os

    procs = []
    for out_path, argv in jobs:
        code = ("import sys; sys.path.insert(0, '.'); import chip_smoke; "
                f"chip_smoke.run_recorded_cli({str(out_path)!r}, "
                f"{list(argv)!r}, {backend!r})")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, env=dict(os.environ)))
    outs, failed = [], []
    try:
        for proc in procs:
            out = proc.communicate(timeout=timeout)[0]
            outs.append(out)
            if proc.returncode != 0:
                failed.append(out[-3000:])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    if failed:
        raise AssertionError("ddp: a process failed:\n" + "\n".join(failed))
    return [json.loads(Path(out_path).read_text()) for out_path, _ in jobs]


def _held_weights(path_a, path_b, steps, taus=(1.0, 0.1, 0.01)):
    """Two checkpoints of ``ModelConfig()`` runs from the seeded weights
    (``TrainConfig().seed``): ({tau: (max |w_a - w_b| over the elements
    whose bias-corrected Adam sqrt(v) in ``path_a`` is at least tau x the
    rms of its tensor's, their share of all elements)}, max |w_a - w_b|
    over all, its tensor, the largest ||w_a - w_b|| / ||w_a - w_0|| of a
    tensor (w_0 the seeded weights), that tensor).  Adam moves an element
    by about lr a step whatever its gradient's size, so where the gradient
    is near zero, or its sum cancels, two sound runs, whose sums round
    apart, move it apart by up to that."""
    import torch

    from commu_tpu_torch.config import ModelConfig, TrainConfig
    from commu_tpu_torch.models import VOCAB_SIZE, TransformerXL

    model = TransformerXL(VOCAB_SIZE, ModelConfig())
    model.init_parameters(torch.Generator().manual_seed(TrainConfig().seed))
    start = {n: p.detach().double() for n, p in model.named_parameters()}
    a, b = (torch.load(p, map_location="cpu", weights_only=False)
            for p in (path_a, path_b))
    state = a["optimizer"]["state"]
    worst, worst_key = max((float((a["model"][k].double()
                                   - b["model"][k].double()).abs().max()), k)
                           for k in a["model"])
    held = {tau: [0.0, 0] for tau in taus}
    total = 0
    moved = []
    for i, name in enumerate(start):
        dw = (a["model"][name].double() - b["model"][name].double()).abs()
        moved.append((float(dw.norm() / (a["model"][name].double()
                                          - start[name]).norm()), name))
        v = state[i]["exp_avg_sq"].double() / (1 - 0.999 ** steps)
        root = v.sqrt()
        rms = float(v.mean().sqrt())
        total += dw.numel()
        for tau in taus:
            mask = root >= tau * rms
            if mask.any():
                held[tau][0] = max(held[tau][0], float(dw[mask].max()))
            held[tau][1] += int(mask.sum())
    return ({tau: (dw, n / total) for tau, (dw, n) in held.items()}, worst,
            worst_key, *max(moved))


def ddp_phase(data_dir: Path, work_dir: Path, card: str) -> dict:
    """``[ddp]``: data parallelism on the one card, at ``TrainConfig()`` and
    ``ModelConfig()`` width, f32, ``WIDE_STEPS`` steps, each run the train
    CLI in a fresh process (``run_recorded_cli``).  First ``--distributed
    --coordinator_address 127.0.0.1:<port> --num_processes 1 --process_id
    0`` over NCCL in the fast mode at dropout 0.1: every step's metrics and
    every weight of ``checkpoint_last.pt`` equal to the bit those of the
    same run without a process group.  Then two ranks on ``cuda:0`` over
    gloo (set by ``run_recorded_cli``), in the exact mode at dropout 0 and
    warmup 0, against one process at ``batch_chunk`` x 2 and ``lr`` / 2
    (and ``lr_min`` / 2: the schedule's floor is the ratio lr_min / lr,
    which the ranks' lr / 2 keeps, and warmup 0 reaches it at the second
    step): each step's ``nll_sum`` and ``grad_norm`` within rtol 1e-5,
    and the last weights where the gradient is not near zero
    (``_held_weights`` at ``DDP_HELD_TAU``) within ``DDP_HELD_TOL`` x the
    learning rates the steps applied, each tensor within ``DDP_MOVED_TOL``
    of its update.  Prints ms/step and peak memory per
    rank.
    Returns the kernel launches of the data-parallel runs (rank 0's)."""
    import torch

    from commu_tpu_torch.config import TrainConfig
    from commu_tpu_torch.ops import _build
    from commu_tpu_torch.parallel import mesh
    from commu_tpu_torch.training.schedule import lr_at

    torch.cuda.empty_cache()  # the ranks share the card with this process
    common = ["--data_dir", str(data_dir), "--dtype", "float32",
              "--max_step", str(WIDE_STEPS), "--set", "train.log_interval=4",
              "--set", f"train.eval_interval={WIDE_STEPS}"]
    jobs = [(work_dir / "one.json", common + ["--work_dir",
                                              str(work_dir / "one")])]
    one = _recorded_runs(jobs)[0]
    port = mesh.free_port()
    jobs = [(work_dir / "nccl1.json", common + [
        "--work_dir", str(work_dir / "nccl1"), "--distributed",
        "--coordinator_address", f"127.0.0.1:{port}", "--num_processes", "1",
        "--process_id", "0"])]
    nccl = _recorded_runs(jobs)[0]
    errors = []
    same = [a[1:] == b[1:] for a, b in zip(one["steps"], nccl["steps"])]
    a = torch.load(f"{one['work_dir']}/checkpoint_last.pt")["model"]
    b = torch.load(f"{nccl['work_dir']}/checkpoint_last.pt")["model"]
    equal = all(torch.equal(a[k], b[k]) for k in a)
    log = (Path(nccl["work_dir"]) / "train_rank0.log").read_text()
    print(f"[ddp] NCCL world 1 (--distributed --num_processes 1), fast mode, "
          f"dropout 0.1, f32, {WIDE_STEPS} steps: metrics bit-equal to one "
          f"process {same}, checkpoint_last bit-equal {equal}; ms/step "
          f"{_step_ms(nccl['steps'], [2, WIDE_STEPS - 1]):.1f} against "
          f"{_step_ms(one['steps'], [2, WIDE_STEPS - 1]):.1f}, peak "
          f"{nccl['peak_mib']:.1f} MiB against {one['peak_mib']:.1f} "
          f"[{card}]")
    if not (all(same) and len(same) == WIDE_STEPS and equal
            and "devices=1" in log):
        errors.append("the NCCL world-1 run is not bit-equal to one process")

    exact = ["--precise_bd", "--set", "model.dropout=0.0", "--set",
             "model.attention_dropout=0.0", "--set", "train.warmup_step=0"]
    oracle = _recorded_runs([(work_dir / "oracle.json", common + exact + [
        "--work_dir", str(work_dir / "oracle"), "--set",
        "train.batch_chunk=8", "--set", "train.lr=0.002", "--set",
        "train.lr_min=0.00005"])])[0]
    port = mesh.free_port()
    ranks = _recorded_runs([
        (work_dir / f"gloo{r}.json", common + exact + [
            "--work_dir", str(work_dir / "gloo"), "--distributed",
            "--coordinator_address", f"127.0.0.1:{port}", "--num_processes",
            "2", "--process_id", str(r), "--device", "cuda:0"])
        for r in (0, 1)], backend="gloo")
    for i, (o, r) in enumerate(zip(oracle["steps"], ranks[0]["steps"])):
        rel = (abs(r[1] - o[1]) / abs(o[1]), abs(r[3] - o[3]) / abs(o[3]))
        print(f"[ddp] gloo 2 ranks on cuda:0 step {i}: nll_sum {r[1]!r} vs "
              f"one process (batch_chunk 8, lr / 2) {o[1]!r} (rel "
              f"{rel[0]:.3e}), grad_norm {r[3]!r} vs {o[3]!r} (rel "
              f"{rel[1]:.3e}), tokens {r[2]:.0f} vs {o[2]:.0f}, rtol 1e-5 "
              f"[{card}]")
        if r[2] != o[2] or max(rel) > 1e-5:
            errors.append(f"gloo step {i}: rel {rel}")
    if [r[1:] for r in ranks[0]["steps"]] != [r[1:] for r in
                                               ranks[1]["steps"]]:
        errors.append("the two ranks' metrics differ")
    tcfg = TrainConfig(lr=0.002, lr_min=0.00005, warmup_step=0)
    applied = sum(lr_at(tcfg, i) for i in range(WIDE_STEPS))
    held, worst, worst_key, ratio, ratio_key = _held_weights(
        f"{oracle['work_dir']}/checkpoint_last.pt",
        f"{ranks[0]['work_dir']}/checkpoint_last.pt", WIDE_STEPS)
    files = sorted(p.name for p in Path(ranks[0]["work_dir"]).iterdir())
    print(f"[ddp] gloo 2 ranks: max |w - oracle| {worst:.3e} at {worst_key}"
          f" ({worst / applied:.3e} of the lr applied, {applied:.3e}); "
          "over the elements whose gradient is not near zero (Adam's "
          "sqrt(v) at least tau x its tensor's rms): " + ", ".join(
              f"tau {tau}: {share:.4f} of the elements, max "
              f"{dw / applied:.3e} of the lr applied"
              for tau, (dw, share) in held.items())
          + f", limit {DDP_HELD_TOL} at tau {DDP_HELD_TAU}; largest "
          f"||w - oracle|| / ||oracle - w_0|| of a tensor {ratio:.3e} at "
          f"{ratio_key} (limit {DDP_MOVED_TOL}); ms/step "
          f"rank 0 "
          f"{_step_ms(ranks[0]['steps'], [2, WIDE_STEPS - 1]):.1f}, rank 1 "
          f"{_step_ms(ranks[1]['steps'], [2, WIDE_STEPS - 1]):.1f} against "
          f"one process {_step_ms(oracle['steps'], [2, WIDE_STEPS - 1]):.1f};"
          f" peak per rank {ranks[0]['peak_mib']:.1f}, "
          f"{ranks[1]['peak_mib']:.1f} MiB against {oracle['peak_mib']:.1f}; "
          f"work dir {files} [{card}]")
    if not held[DDP_HELD_TAU][0] <= DDP_HELD_TOL * applied:
        errors.append(f"gloo weights {held[DDP_HELD_TAU][0]:.3e} from the "
                      "oracle where the gradient is not near zero")
    if not ratio <= DDP_MOVED_TOL:
        errors.append(f"gloo weights: {ratio_key} {ratio:.3e} of its update "
                      "from the oracle")
    if files != ["checkpoint_best.pt", "checkpoint_last.pt", "config.yml",
                 "train_rank0.log", "train_rank1.log"]:
        errors.append(f"gloo work dir {files}")
    if errors:
        raise AssertionError("ddp: " + "; ".join(errors))
    launches = {name: nccl["launches"].get(name, 0)
                + ranks[0]["launches"].get(name, 0) for name in _build.LAUNCHES}
    return launches


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device "
                         "(torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from commu_tpu_torch.ops import _build

    card = _card()
    print(f"[card] {card}")
    print(f"[versions] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    levers_built = None
    if LEVERS_ONLY or not any(arg.startswith("--") for arg in sys.argv[1:]):
        # the lever library builds beside the main one, and both are ready
        # before the first timed phase
        import threading

        levers_built = threading.Thread(target=_build.lever_library,
                                        daemon=True)
        levers_built.start()
    _build.library()
    build = _build.build_seconds
    print(f"[build] nvcc sm_90a: "
          f"{'%.1f s' % build if build is not None else 'reused'} "
          f"(library ready after {time.perf_counter() - t0:.1f} s)")
    if levers_built is not None:
        levers_built.join()
        _build.lever_library()  # raises here if the thread's build failed
        built = _build.lever_build_seconds
        print(f"[build] lever library, nvcc sm_90a -DCOMMU_LEVERS: "
              f"{'%.1f s' % built if built is not None else 'reused'}, "
              f"beside the main build (both ready after "
              f"{time.perf_counter() - t0:.1f} s)")
    print_ptxas()
    print_sass(card)

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"[phase] {name}: {time.perf_counter() - t0:.1f} s")
        return out

    if SASS_ONLY:
        print(card)
        return
    if PARSE_CLIPS is not None:
        with tempfile.TemporaryDirectory() as tmp:
            phase("parse", parse_profile, Path(tmp), PARSE_CLIPS)
        print(card)
        return
    if SUMS_ONLY:
        phase("sums", sums_check, card)
        print(card)
        return
    if KV_ONLY:
        phase("kv", time_kv, card)
        print(card)
        return
    if CONVERGE_ONLY:
        with tempfile.TemporaryDirectory() as tmp:
            phase("converge", converge_phase, Path(tmp), card)
        print(card)
        return
    if KERNELS_ONLY:
        phase("train kernels", check_train_kernels, card)
        phase("capacity-0 and probe kernels",
              check_capacity0_and_probe_kernels, card)
        phase("fast-numerics kernels", check_fast_kernels, card)
        print(card)
        return
    if STEPS:
        phase("steps", time_steps, card)
        print(card)
        return
    if LEVERS_ONLY:
        phase("lever kernels", check_lever_kernels, card)
        with tempfile.TemporaryDirectory() as tmp:
            rng = np.random.RandomState(6)
            write_corpus(Path(tmp) / "train", [400 + 80 * i for i in range(10)],
                         seed=7, train_lengths=rng.randint(300, 3001, size=600))
            phase("levers", levers_phase, Path(tmp) / "train",
                  Path(tmp) / "runs_levers", card)
        print(card)
        return
    if EVAL_WINDOW:
        phase("eval window", time_eval_window, card)
        print(card)
        return
    if SERVE_ONLY:
        with tempfile.TemporaryDirectory() as tmp:
            pt_path = Path(tmp) / "model.pt"
            write_weights(pt_path)
            from commu_tpu_torch.generation import device_sampler
            if hasattr(device_sampler, "cached_episode"):
                phase("decode episode graphs", check_episode_graphs, pt_path,
                      card, {})
            phase("serve", serve, pt_path, Path(tmp) / "out", card)
        print(card)
        return
    if CHAIN_ONLY:
        with tempfile.TemporaryDirectory() as tmp:
            rng = np.random.RandomState(6)
            write_corpus(Path(tmp) / "train", [400 + 80 * i for i in range(10)],
                         seed=7, train_lengths=rng.randint(300, 3001, size=600))
            phase("train, fast mode, seeded corpus", train,
                  Path(tmp) / "train", Path(tmp) / "runs_fast", card, True,
                  ("bfloat16",), CHAIN_STEPS, (), FAST_TRAIN_KERNELS,
                  FAST_UNWANTED, None, {"rel_attention_mem_bwd[int8]": 6,
                                        "ffn_block_bwd[bits8]": 6}, False)
            phase("corpus chain", corpus_chain, Path(tmp) / "chain", card)
        print(card)
        return
    if PASSES and WIDE_ONLY:
        phase("wide backward passes", time_wide_bwd_passes, card)
        print(card)
        return
    if PROJ_ONLY and WIDE_ONLY:
        if PARENT_DIR is not None:
            phase("#6 in turns", wide_in_turns, card, PARENT_DIR, True)
        phase("#6 at the wide widths", check_wide_kernels, card, True)
        print(card)
        return
    if (PROFILE_ONLY or HOST_ONLY or UNFUSED_ONLY or WIDE_ONLY or DDP_ONLY
            or GRADS_ONLY or C2_ONLY):
        with tempfile.TemporaryDirectory() as tmp:
            rng = np.random.RandomState(6)
            write_corpus(Path(tmp) / "train", [400 + 80 * i for i in range(10)],
                         seed=7, train_lengths=rng.randint(300, 3001, size=600))
            if GRADS_ONLY:
                phase("grads", grad_attribution, Path(tmp) / "train", card)
            if C2_ONLY:
                phase("c2", c2_reading, Path(tmp) / "train",
                      Path(tmp) / "runs_c2", card)
            if WIDE_ONLY and PARENT_DIR is not None:
                phase("wide forms in turns", wide_in_turns, card, PARENT_DIR)
                phase("wide backwards in turns", wide_bwd_in_turns, card,
                      PARENT_DIR)
            if WIDE_ONLY:
                phase("wide kernels", check_wide_kernels, card)
                phase("wide", wide_phase, Path(tmp) / "train",
                      Path(tmp) / "runs_wide", card)
            if DDP_ONLY:
                phase("ddp", ddp_phase, Path(tmp) / "train",
                      Path(tmp) / "runs_ddp", card)
            if PROFILE_ONLY:
                phase("profile", profile_split, Path(tmp) / "train",
                      Path(tmp) / "runs_profile", card)
            if HOST_ONLY:
                write_weights(Path(tmp) / "model.pt")
                phase("host sampler", host_sampler_phase,
                      Path(tmp) / "model.pt", Path(tmp) / "out_host", card)
            if UNFUSED_ONLY:
                phase("unfused", unfused_phase, Path(tmp) / "train",
                      Path(tmp) / "runs_unfused", card)
        print(card)
        return
    if PASSES:
        phase("kv", time_kv, card)
        phase("probe forms", time_probe_forms, card)
        phase("NLL passes", time_nll_passes, card)
        phase("forward forms", time_forward_forms, card)
        phase("fast-numerics kernels", check_fast_kernels, card)
        phase("wide backward passes", time_wide_bwd_passes, card)
        phase("small kernels by device time", time_small_kernels, card, {})
        print(card)
        return
    kernels = phase("serving kernels", check_kernels, card)
    kernels.update(phase("eval kernels", check_eval_kernels, card))
    kernels.update(phase("train kernels", check_train_kernels, card))
    kernels.update(phase("capacity-0 and probe kernels",
                         check_capacity0_and_probe_kernels, card))
    kernels.update(phase("fast-numerics kernels", check_fast_kernels, card))
    phase("fast-numerics kernels at tgt_length 512", check_fast_kernels, card,
          *LONG_CHUNK)
    kernels.update(phase("lever kernels", check_lever_kernels, card))
    phase("small kernels by device time", time_small_kernels, card, kernels)
    with tempfile.TemporaryDirectory() as tmp:
        pt_path = Path(tmp) / "model.pt"
        write_weights(pt_path)
        phase("serving model", check_model, pt_path, card)
        episode_launches = phase("decode episode graphs",
                                 check_episode_graphs, pt_path, card, kernels)
        serve_launches = phase("serve", serve, pt_path, Path(tmp) / "out",
                               card)
        write_corpus(Path(tmp) / "short", [700, 500, 650], seed=2)
        phase("eval model", check_eval_model, Path(tmp) / "short", card)
        write_corpus(Path(tmp) / "val", EVAL_LENGTHS, seed=3)
        eval_launches = phase("eval", evaluate, Path(tmp) / "val", card)
        phase("train model", check_train_model, card, 0.0)
        phase("train model, dropout", check_train_model, card, DROPOUT_P)
        phase("train model, fast mode", check_train_model, card, DROPOUT_P,
              256, True)
        phase("train model, fast mode, no memory", check_train_model, card,
              DROPOUT_P, 0, True)
        rng = np.random.RandomState(6)
        write_corpus(Path(tmp) / "train", [400 + 80 * i for i in range(10)],
                     seed=7, train_lengths=rng.randint(300, 3001, size=600))
        train_launches, _ = phase(
            "train, dropout 0", train, Path(tmp) / "train",
            Path(tmp) / "runs0", card, False, ("bfloat16",), 4)
        dropout_launches, nll_sums = phase(
            "train", train, Path(tmp) / "train", Path(tmp) / "runs", card,
            True, ("bfloat16", "float32"), PRECISE_STEPS)
        phase("train model, no memory", check_train_model, card, DROPOUT_P, 0)
        capacity0_launches, _ = phase(
            "train, no memory", train, Path(tmp) / "train",
            Path(tmp) / "runs_m0", card, True, ("bfloat16", "float32"),
            PRECISE_STEPS, NO_MEMORY, CAPACITY0_KERNELS, MEMORY_KERNELS,
            None, {"rel_attention_bwd": 6, "ffn_block_bwd": 6})
        fast_launches, _ = phase(
            "train, fast mode", train, Path(tmp) / "train",
            Path(tmp) / "runs_fast", card, True, ("bfloat16", "float32"), 12,
            (), FAST_TRAIN_KERNELS, FAST_UNWANTED, None,
            {"rel_attention_mem_bwd[int8]": 6, "ffn_block_bwd[bits8]": 6},
            False)
        fast0_launches, _ = phase(
            "train, fast mode, no memory", train, Path(tmp) / "train",
            Path(tmp) / "runs_fast_m0", card, True, ("bfloat16", "float32"),
            12, NO_MEMORY, FAST_CAPACITY0_KERNELS,
            FAST_UNWANTED + MEMORY_KERNELS + ("rel_attention_mem_fwd[int8]",
                                              "rel_attention_mem_bwd[int8]"),
            None, {"rel_attention_bwd[int8]": 6, "ffn_block_bwd[bits8]": 6},
            False)
        # past the first design's shared memory (T <= 483 in the int8
        # form): the window of 512 on the tensor-core body
        long_launches, _ = phase(
            "train, fast mode, no memory, tgt_length 512", train,
            Path(tmp) / "train", Path(tmp) / "runs_fast_t512", card, True,
            ("bfloat16",), 4, NO_MEMORY + LONG_WINDOW, FAST_CAPACITY0_KERNELS,
            FAST_UNWANTED + MEMORY_KERNELS + ("rel_attention_mem_fwd[int8]",
                                              "rel_attention_mem_bwd[int8]"),
            None, {"rel_attention_bwd[int8]": 6, "ffn_block_bwd[bits8]": 6},
            False)
        probe_launches = phase("probes", probes, Path(tmp) / "train",
                               Path(tmp) / "runs_probe", card,
                               nll_sums["float32"])
        lever_launches = phase("levers", levers_phase, Path(tmp) / "train",
                               Path(tmp) / "runs_levers", card)
        ring_launches = phase("ring write", check_ring_write, card)
        profile_launches = phase("profile", profile_split,
                                 Path(tmp) / "train",
                                 Path(tmp) / "runs_profile", card)
        host_launches = phase("host sampler", host_sampler_phase, pt_path,
                              Path(tmp) / "out_host", card)
        unfused_launches = phase("unfused", unfused_phase,
                                 Path(tmp) / "train",
                                 Path(tmp) / "runs_unfused", card)
        if PARENT_DIR is not None:
            phase("wide forms in turns", wide_in_turns, card, PARENT_DIR)
            phase("wide backwards in turns", wide_bwd_in_turns, card,
                  PARENT_DIR)
        phase("wide kernels", check_wide_kernels, card)
        wide_launches = phase("wide", wide_phase, Path(tmp) / "train",
                              Path(tmp) / "runs_wide", card)
        ddp_launches = phase("ddp", ddp_phase, Path(tmp) / "train",
                             Path(tmp) / "runs_ddp", card)
        chain_launches = phase("corpus chain", corpus_chain,
                               Path(tmp) / "chain", card)
        phase("converge, short form", converge_phase, Path(tmp) / "converge",
              card, CONVERGE_SHORT_STEPS)

    if any(m.split(".")[0] in ("jax", "flax", "commu_tpu")
           for m in sys.modules):
        raise AssertionError("JAX or the JAX package was imported")
    missing = sorted(set(KERNEL_INFO) - set(kernels))
    if missing:
        raise AssertionError(f"kernels {missing} have no result row")
    paths = {"serve": serve_launches, "serve_episodes": episode_launches,
             "eval": eval_launches,
             "train_dropout0": train_launches, "train": dropout_launches,
             "train_capacity0": capacity0_launches,
             "train_fast": fast_launches,
             "train_fast_capacity0": fast0_launches,
             "train_fast_capacity0_t512": long_launches,
             "probes": probe_launches, "levers": lever_launches,
             "ring_check": ring_launches,
             "profile": profile_launches, "host_sampler": host_launches,
             "unfused": unfused_launches, "wide": wide_launches,
             "ddp": ddp_launches, "corpus_chain": chain_launches}
    idle = [name for name in kernels
            if not any(path.get(name, 0) for path in paths.values())]
    if idle:
        raise AssertionError(f"kernels {idle} launched on no path")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": KERNEL_INFO[name][0],
         "replaces": KERNEL_INFO[name][1],
         "launches": sum(path.get(name, 0) for path in paths.values()),
         **{f"launches_{key}": path.get(name, 0)
            for key, path in paths.items()},
         **row}
        for name, row in kernels.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
