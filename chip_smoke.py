#!/usr/bin/env python3
"""Bring-up check of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, each of which raises on failure (the exit code is then non-zero):

1. Print the card (``nvidia-smi``) and the host's memory, build the five
   hand-written CUDA kernels from the repository's sources (one ``nvcc``
   per source, all started together) and print the build time and the
   compiler's register report.
2. Hold ``swa_flash`` against its plain PyTorch version on the card at the
   olmo serving shape (bf16 and f32), at two ragged/windowed shapes, at
   the olmo-1b training shapes (B 4 and 2, S 4096, bf16), at head dims 80
   and 120 (bf16 and f32), at bf16 cases with a window shorter than S
   and a ragged S, at phase 7's olmo-1b smoke shape, at zamba2-1.2b's
   training shapes (H 32, D 64, window 4096 = S), granite-moe's serving
   and training ones (H 24, D 64), h2o-danube-3-4b's prefill (B 2, S
   6144, H 32, D 120, window 4096 < S), llama-3.2-vision-11b's prefill
   (H 32, D 128), whisper-base's prefill and training ones (H 8, D 64)
   and llama-3.2-vision-11b's training ones (B 4 and 2, S 4096, H 32, D
   128); ``torch.library.opcheck`` of the op ``repro_torch::swa_flash`` on
   CUDA inputs (schema; its fake implementation against the kernel's
   outputs), as phases 2b, 2c and 2d do for their ops; then, at the shapes
   of ``SWA_TIMED``, time the kernel (back to back,
   and with the L2 flushed before each launch), the plain version and
   PyTorch's ``scaled_dot_product_attention`` (the yardstick, with the
   window as a boolean mask where it is shorter than S; the port never
   calls it) beside the kernel's bound.
2e. Hold ``swa_flash_bwd`` (the backward of ``swa_flash``) against the
   plain backward on the same bf16 inputs at ``BWD_CASES`` (head dims 64,
   80, 120 and 128, a window, a ragged S); ``torch.library.opcheck`` of
   the op on CUDA inputs; then, at olmo-1b's and granite-moe's training
   calls (``BWD_TIMED``), time it (back to back, and its kernels' device
   time by the profiler) and the plain backward beside the bound of its
   least work (the four products over the causal pairs).
2b. Hold ``ssd_intra_chunk`` against its plain version at the mamba2-130m
   serving shape (bf16 and f32), the zamba2-1.2b one and bf16 cases in
   groups of heads (head dims 16, 32 and 128, a ragged chunk, N 40 and 33,
   H 5) and at the mamba2-130m training shapes (BC 128 and 64, groups of
   8 heads), phase 7's mamba2-130m smoke shapes and zamba2-1.2b's training
   shapes (BC 128 and 64, H 64, N 64); run the whole SSD wrapper at a
   ragged length against the
   plain chunked scan, the O(L) recurrence and its own ``initial_state``
   continuation; time the kernel (back to back, and its device time by the
   profiler) and the plain version beside the kernel's bound at both
   serving shapes and the mamba2 and zamba2 training ones at BC 128 (no
   PyTorch call computes this function).
2c. Hold ``fused_ce_stats`` against its plain version at the olmo-1b
   training shapes (T 16384 and 8192 tokens, d 2048, V 50304, bf16, the
   head read in place as ``embed.T``), at mamba2-130m's (the same T, d
   768, V 50280), phase 7's smoke shapes (d 256, V 512, bf16), a ragged
   f32 case, zamba2-1.2b's (d 2048, V 32000, an untied head read in place)
   granite-moe's (d 1536, V 49155, an untied head the wrapper copies
   for TMA: 1 copy a call, asserted), whisper-base's (d 512, V 51865,
   copied likewise) and llama-3.2-vision-11b's (d 4096, V 128256, an
   untied head read in place); compare the
   (sum, count) of ``fused_cross_entropy`` with the full-logits plain CE;
   time the kernel (back to back, and with the L2 flushed before each
   launch) and the plain version beside the kernel's bound, with cuBLAS's
   time for the bare ``h @ W`` GEMM printed for context (no PyTorch call
   computes (lse, pick)).
2d. Hold ``fingerprint_u32`` against its plain version bit for bit at the
   shapes of ``tests/test_kernels.py``, a bf16 and an f16 array, a length
   that is not a multiple of the 32,768-word block (also through a view
   that is not 16-byte aligned), an int64 array, the 4 MB array of
   ``benchmarks/kernels_bench.py`` and olmo-1b's largest leaf (1 GiB of
   f32); time it at the last two beside its bound, the plain version and
   ``torch.sum`` over the same int32 words (one read of the bytes; no
   PyTorch call computes the digest).
3. Drive the port's serving paths at full width, each through
   ``ServingEngine``, which generates 32 greedy tokens for 4 prompts of
   512 with random weights from seed 0: olmo-1b (16 layers, d_model 2048,
   bf16), then mamba2-130m (24 layers, d_model 768, bf16), then
   zamba2-1.2b (38 Mamba2 layers and 6 applications of one shared
   attention block, d_model 2048, bf16), then granite-moe-3b-a800m (32
   layers of attention with 24 query and 8 KV heads and 40 experts of
   d_ff 512, top-8, d_model 1536, vocab 49155, bf16), h2o-danube-3-4b
   (24 layers, 32 heads of 120, window 4096, bf16) on 2 prompts of 6,144
   (``SERVE_SHAPES``: past the window, so prefill fills the KV ring and
   every decode step wraps it), whisper-base (6 encoder and 6 decoder
   layers, d_model 512, encoder frames (4, 1500, 512)) and
   llama-3.2-vision-11b (40 layers and 8 cross blocks, 32 query and 8 KV
   heads of 128, image embeddings (4, 1601, 1280)), their cross gates set
   to [0.3, 0.9) so that the encoder and the cross caches reach the
   tokens.  Every kernel's
   launch count is set to 0 just before each path and read just after
   (and the wrappers must copy no operand for TMA on the way): olmo
   launches
   ``swa_flash`` once per layer; mamba2 ``ssd_intra_chunk`` once per layer;
   zamba2 both, once per Mamba2 layer and once per shared block; granite,
   h2o-danube, whisper (its decoder) and llama-vision ``swa_flash`` once
   per layer (the encoder and cross attention run a plain core).  Then
   time prefill and decode, profile one of each, and check
   decode-vs-prefill at bf16 (MoE at a capacity factor where nothing
   drops, as tests/test_decode_consistency.py; h2o-danube over 3 decode
   steps past the wrap).
3b. f32 checks: decode-vs-prefill at full width for each model
   (h2o-danube from a prompt of 4,160 past its window), and the card path
   against the CPU path on the olmo, mamba2 and granite-moe smoke configs;
   on the h2o-danube (a prompt of 160 past its window of 128, 40 decode
   steps), whisper and llama-vision smoke configs, gates set, decode
   against prefill on the card and the card against the CPU.
4. Train olmo-1b at full width (bf16 compute, f32 master weights and
   AdamW) through the port's ``ElasticRuntime``: logical world 4, global
   batch 4 of 4096 tokens, 3 steps at 4 physical devices (splice 1), then
   ``resize(2)`` and 2 steps at splice 2.  First the kernel path against
   the plain path on the first batch (loss, grad_norm, a nonzero gradient
   for every leaf); then the main path, counts set to 0 just before and
   read just after, with each step's launches asserted (1
   ``fused_ce_stats``, 32 ``swa_flash`` and 16 ``swa_flash_bwd`` per
   slice: 16 layers in the forward and 16 again in remat's recomputation,
   and 16 backward), its time, tokens/s,
   peak memory and share of the bf16 peak; a profile of one step; the
   first loss against ln V + sigma^2 / 2; splice 1 against splice 2 from
   one state at full width with 4 layers.
4b. f32, card against CPU: one training step of the olmo smoke config
   from one bridged state on each device; loss, moments and parameters.
5. Take phase 4's olmo-1b job (world 4, at splice 2) through the paper's
   preemption and migration flow, the path ``olmo-1b-migrate``, counts set
   to 0 just before and read just after: a preemption request quiesces it
   through the barrier carried by the step (within 2 steps); every leaf of
   its state is fingerprinted on the card (26 ``fingerprint_u32``, only the
   digests cross to the host); ``migrate`` dumps it into a content-deduped
   store for its 4 workers, models the transfer and restores it on a new
   runtime at 4 physical devices; the restored state's 26 digests must
   equal the source's, the resume be work-conserving and the stored device
   bytes at most the logical bytes / W (Table 4); one step on each runtime
   at splice 1 must give the same loss within 1e-6 relative (and says
   whether it is equal to the bit, and which leaves of the two states
   after that step differ: a check of the step's determinism, outside the
   path's count).  It prints Table 5's components, the stored bytes, the
   per-GB host rates of the dump's and restore's steps, and the host's and
   the card's peak memory.
6. Train mamba2-130m at full width (24 Mamba2 layers, d_model 768, bf16
   compute, f32 master weights) through ``ElasticRuntime``, the path
   ``mamba2-130m-train``, on phase 4's schedule and with its checks: the
   kernel path against the plain path on the first batch, a nonzero
   gradient for every leaf (``A_log``, ``D``, ``dt_bias`` and ``conv_w``
   named), 48 ``ssd_intra_chunk`` (24 layers, again in remat's
   recomputation) and 1 ``fused_ce_stats`` per slice, step time, tokens/s,
   peak memory, the share of the bf16 peak, a profile of one step, the
   first loss against ln V + sigma^2 / 2, splice 1 against splice 2 at 4
   layers.
6b. f32, card against CPU: one training step of the mamba2 smoke config.
7. Run the three scenarios of ``tests/test_executor.py`` through the
   port's ``FleetExecutor`` on the card (the path ``fleet-executor``:
   olmo-1b and mamba2-130m smoke jobs preempted, restored at the exact
   step, shrunk, failed and rolled back) with that file's assertions, and
   again on the CPU: each log must equal the CPU's.
8. Train zamba2-1.2b at full width (38 Mamba2 layers in 6 groups of 6,
   each group followed by the one shared attention block, then 2 tail
   layers) through ``ElasticRuntime``, the path ``zamba2-1.2b-train``, on
   phase 4's schedule and with its checks: 76 ``ssd_intra_chunk`` (38
   layers, again in remat's recomputation of each group), 12 ``swa_flash``
   and 1 ``fused_ce_stats`` per slice; splice 1 against splice 2 at 7
   layers (one group and a tail layer).
8b. f32, card against CPU: one training step of the zamba2 smoke config.
9. Train granite-moe-3b-a800m at its full size (32 layers, 40 experts,
   top-8, vocab 49155) with the donated step (``donate``: params, m and v
   updated in place, 16 bytes a parameter), the path
   ``granite-moe-train``, on phase 4's schedule and with its checks: 64
   ``swa_flash`` (32 layers, again under remat) and 1 ``fused_ce_stats``
   per slice, and the head copied for TMA once per slice; it prints the
   state's ``torch.cuda.memory_allocated()`` after setup, and one donated
   update's transient memory, held under two axis-0 slices of the largest
   leaf.
9b. f32, card against CPU: one training step of the granite smoke config.
10. Train whisper-base at full width (6 encoder and 6 decoder layers,
   encoder frames drawn once by the runtime, cross gates set), the path
   ``whisper-base-train``, on phase 4's schedule and with its checks: 12
   ``swa_flash`` (the decoder's self-attention, again in remat's
   recomputation) and 1 ``fused_ce_stats`` per slice, the (512, 51865)
   head copied for TMA once per slice.
10b. f32, card against CPU: one training step of the whisper smoke config.
12. After 10b, train llama-3.2-vision-11b at full width and 5 of its 40
   layers (one group of 5 layers with its cross block, image embeddings
   drawn once by the runtime, cross gates set) with the donated step, the
   path ``vlm-train``, on phase 4's schedule and with its checks: 10
   ``swa_flash`` (5 layers, again in the group's remat) and 1
   ``fused_ce_stats`` per slice, the head read in place; splice 1 against
   splice 2 at the same depth, donated.
12b. f32, card against CPU: one training step of the llama-vision smoke
   config.
11. Run a seeded fleet trace (failures, the serving tier, scaling curves)
   through the port's ``FleetSimulator``, the path ``fleet-sim``: numpy on
   the host, no kernel; it prints the digest of every decision (the JAX
   simulator's, on the CPU) and its wall time.
``donate`` (after 4b). The donated step against the functional one on the
   olmo-1b smoke config: three steps from copies of one state; losses,
   params, m and v equal to the bit.
``dryrun`` (after 11, host only). The planner (``python -m
   repro_torch.launch.dryrun``, one process per pair of ``DRYRUN_PAIRS``,
   all at once): olmo-1b, granite-moe and llama-3.2-vision-11b train_4k,
   zamba2-1.2b prefill_32k and yi-9b decode_32k (donated) on the 16 x 16
   or 2 x 16 x 16 meshes, traced on fake tensors in a fake world; their
   roofline terms (data-sheet models), bytes per device and trace seconds;
   and granite-moe train_4k on one device, donated, whose state bytes must
   be within 1% of phase 9's on the card and whose ``swa_flash`` ops a
   slice must equal phase 9's launches a slice.  The kernels run there as
   their ``torch.library`` ops' fake implementations; each pair's kernel
   ops are printed.
13. Print the ``kernels`` JSON line, the card's name and power limit, and as
   the last line ``{"ok": true, "device": {...}}``.

It imports no JAX and nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# swa_flash vs plain version on the card: (B, S, H, D, window, dtype name)
KERNEL_CASES = [
    (4, 512, 16, 128, 0, "bfloat16"),   # the olmo serving path's shape
    (4, 512, 16, 128, 0, "float32"),
    (2, 200, 3, 64, 96, "float32"),     # ragged S, odd window
    (1, 128, 1, 32, 48, "float32"),
    (4, 4096, 16, 128, 0, "bfloat16"),  # olmo-1b training, splice 1
    (2, 4096, 16, 128, 0, "bfloat16"),  # splice 2: one slice
    # head dims 80 (paper-gpt2-1.8b: 1920 / 24) and 120 (h2o-danube-3-4b:
    # 3840 / 32), each in bf16 and in f32
    (2, 512, 24, 80, 0, "bfloat16"),
    (2, 512, 24, 80, 0, "float32"),
    (2, 512, 32, 120, 0, "bfloat16"),
    (2, 512, 32, 120, 0, "float32"),
    (1, 1000, 8, 128, 256, "bfloat16"),  # a window shorter than S
    (2, 333, 4, 120, 100, "bfloat16"),   # ragged S and a window
    (8, 32, 4, 64, 0, "bfloat16"),       # phase 7's olmo-1b smoke jobs
    # zamba2-1.2b training (phase 8), splice 1 and 2: 32 heads of 64, its
    # window of 4096 = S
    (4, 4096, 32, 64, 4096, "bfloat16"),
    (2, 4096, 32, 64, 4096, "bfloat16"),
    # granite-moe-3b-a800m: serving (phase 3) and training (phase 9) at
    # splice 1 and 2; 24 query heads of 64, the 8 KV heads repeated
    (4, 512, 24, 64, 0, "bfloat16"),
    (4, 4096, 24, 64, 0, "bfloat16"),
    (2, 4096, 24, 64, 0, "bfloat16"),
    # h2o-danube-3-4b's prefill (phase 3): 32 heads of 120, its window of
    # 4096 shorter than S 6144, so the mask cuts both ends of each row
    (2, 6144, 32, 120, 4096, "bfloat16"),
    # llama-3.2-vision-11b's prefill: 32 heads of 128 (the 8 KV heads
    # repeated); whisper-base's prefill (8 heads of 64) and its training
    # slices (phase 10) at splice 1 and 2
    (4, 512, 32, 128, 0, "bfloat16"),
    (4, 512, 8, 64, 0, "bfloat16"),
    (4, 4096, 8, 64, 0, "bfloat16"),
    (2, 4096, 8, 64, 0, "bfloat16"),
    # llama-3.2-vision-11b training (``VLM_TRAIN_PATH``), splice 1 and 2:
    # 32 heads of 128, the 8 KV heads repeated
    (4, 4096, 32, 128, 0, "bfloat16"),
    (2, 4096, 32, 128, 0, "bfloat16"),
]
# timed: (case, key suffix in the kernels line, iterations)
SWA_TIMED = [(KERNEL_CASES[0], "", 200), (KERNEL_CASES[4], "_train", 20),
             (KERNEL_CASES[13], "_zamba2_train", 20),
             (KERNEL_CASES[15], "_granite", 200),
             (KERNEL_CASES[16], "_granite_train", 20),
             (KERNEL_CASES[18], "_h2o", 20),
             (KERNEL_CASES[19], "_llama_vision", 200),
             (KERNEL_CASES[20], "_whisper", 200),
             (KERNEL_CASES[21], "_whisper_train", 20),
             (KERNEL_CASES[23], "_vlm_train", 20)]
# swa_flash_bwd vs the plain backward on the card, bf16: (B, S, H, D,
# window)
BWD_CASES = [
    (4, 4096, 16, 128, 0),    # olmo-1b training, splice 1
    (4, 4096, 24, 64, 0),     # granite-moe-3b-a800m training, splice 1
    (1, 4096, 16, 128, 0),    # olmo-1b at splice 4: a row a slice
    (4, 4096, 32, 64, 4096),  # zamba2-1.2b training: its window of S
    (2, 512, 24, 80, 0),      # head dim 80, padded to 80
    (2, 333, 4, 120, 100),    # head dim 120, a ragged S and a window
    (1, 1000, 8, 128, 256),   # a window shorter than S
]
# each of dq, dk, dv to this share of the plain one's largest entry:
# tests/test_torch_cuda.py's bound (one bf16 rounding of each result, the
# hi + lo residual of P and dS, delta from the bf16 o, f32 atomics in
# another order)
BWD_TOL = 2e-2
BWD_TIMED = [(BWD_CASES[0], "_train", 20), (BWD_CASES[1], "_granite_train", 20)]
L2_FLUSH_BYTES = 64 << 20  # written between calls: more than the 50 MB L2
# The kernel and the plain version both accumulate in f32 and differ in
# the order of summation: 2e-5 at f32 (tests/test_kernels.py's bound).  At
# bf16 each rounds its f32 result to bf16 once, so they may differ by one
# bf16 ulp: 2**-7 relative.
TOLERANCE = {"float32": dict(rtol=2e-5, atol=2e-5),
             "bfloat16": dict(rtol=2 ** -7, atol=2e-5)}

# ssd_intra_chunk vs plain version: (BC, Q, H, P, N, dtype name).  Both
# widen every operand to f32 and sum in f32 in another order; outputs are
# f32: tests/test_kernels.py's bound of the kernel against its oracle.
SSD_CASES = [
    (16, 128, 24, 64, 128, "bfloat16"),  # mamba2-130m, batch 4 x 512
    (16, 128, 24, 64, 128, "float32"),
    (16, 128, 64, 64, 64, "bfloat16"),   # zamba2-1.2b, batch 4 x 512
    (64, 128, 6, 16, 64, "bfloat16"),    # the other head dims; G 3
    (64, 128, 6, 32, 64, "bfloat16"),
    (64, 128, 6, 128, 128, "bfloat16"),
    (64, 100, 6, 64, 64, "bfloat16"),    # a ragged chunk
    (64, 128, 6, 64, 40, "bfloat16"),    # N not a multiple of 16
    (64, 128, 6, 64, 33, "bfloat16"),    # odd N: rows not 16-byte aligned
    (64, 128, 5, 64, 64, "bfloat16"),    # groups of 3 and 2 heads
    # mamba2-130m training, 4 x 4096 tokens (splice 1) and 2 x 4096
    # (splice 2): G 8, 3 groups, BC x 3 blocks over several waves
    (128, 128, 24, 64, 128, "bfloat16"),
    (64, 128, 24, 64, 128, "bfloat16"),
    # phase 7's mamba2-130m smoke jobs: 8 and 4 sequences of one chunk
    (8, 32, 16, 32, 16, "bfloat16"),
    (4, 32, 16, 32, 16, "bfloat16"),
    # zamba2-1.2b training (phase 8), splice 1 and 2: 64 heads, N 64, G 8
    (128, 128, 64, 64, 64, "bfloat16"),
    (64, 128, 64, 64, 64, "bfloat16"),
]
# timed: (case, key suffix in the kernels line)
SSD_TIMED = [(SSD_CASES[0], ""), (SSD_CASES[2], "_zamba2"),
             (SSD_CASES[10], "_train"), (SSD_CASES[14], "_zamba2_train")]
SSD_TOL = dict(rtol=1e-4, atol=1e-4)
SSD_RAGGED = (1, 200, 2, 64, 32, 64)     # (B, L, H, P, N, chunk): wrapper

# fused_ce_stats vs plain version: (T, d, V, dtype name, head as embed.T);
# an untied head is a contiguous (d, V) tensor, as ``head.to(bf16)`` gives
CE_CASES = [
    (16384, 2048, 50304, "bfloat16", True),  # olmo-1b training, splice 1
    (8192, 2048, 50304, "bfloat16", True),   # splice 2: one slice
    (300, 256, 777, "float32", False),       # ragged T and V, labels -1
    # mamba2-130m training, splice 1 and 2: 12 k tiles of 64, a last vocab
    # tile of 104 columns
    (16384, 768, 50280, "bfloat16", True),
    (8192, 768, 50280, "bfloat16", True),
    # phase 7's smoke jobs (olmo-1b and mamba2-130m): d 256, V 512
    (256, 256, 512, "bfloat16", True),
    (128, 256, 512, "bfloat16", True),
    # zamba2-1.2b training, splice 1 and 2: the untied (2048, 32000) head,
    # read in place (its row stride a multiple of 8)
    (16384, 2048, 32000, "bfloat16", False),
    (8192, 2048, 32000, "bfloat16", False),
    # granite-moe-3b-a800m training: the untied (1536, 49155) head, whose
    # row stride is no multiple of 8, so the wrapper copies it K-major for
    # TMA on every call (one copy per call, counted)
    (16384, 1536, 49155, "bfloat16", False),
    (8192, 1536, 49155, "bfloat16", False),
    # whisper-base training, splice 1 and 2: the untied (512, 51865) head,
    # copied for TMA as granite's (one copy per call)
    (16384, 512, 51865, "bfloat16", False),
    (8192, 512, 51865, "bfloat16", False),
    # llama-3.2-vision-11b training, splice 1 and 2: the untied (4096,
    # 128256) head, read in place
    (16384, 4096, 128256, "bfloat16", False),
    (8192, 4096, 128256, "bfloat16", False),
]
# timed: (case, key suffix in the kernels line)
CE_TIMED = [(CE_CASES[0], ""), (CE_CASES[1], "_t8192"),
            (CE_CASES[3], "_t16384_d768"), (CE_CASES[4], "_t8192_d768"),
            (CE_CASES[7], "_zamba2"), (CE_CASES[9], "_granite"),
            (CE_CASES[11], "_whisper"), (CE_CASES[12], "_whisper_t8192"),
            (CE_CASES[13], "_vlm")]
# Both sum the same f32 products (exact for bf16 operands) in another
# order, over d <= 2048 terms; logits are about 1 and lse about 11
CE_TOL = dict(rtol=1e-5, atol=1e-4)

BATCH, PROMPT, NEW_TOKENS = 4, 512, 32
# the serving paths, each with its kernels' launches per prefill
PATHS = [(arch, dict(zip(("swa_flash", "ssd_intra_chunk", "fused_ce_stats",
                          "fingerprint_u32", "swa_flash_bwd"), counts)))
         for arch, counts in (("olmo-1b", (16, 0, 0, 0, 0)),
                              ("mamba2-130m", (0, 24, 0, 0, 0)),
                              ("zamba2-1.2b", (6, 38, 0, 0, 0)),
                              ("granite-moe-3b-a800m", (32, 0, 0, 0, 0)),
                              ("h2o-danube-3-4b", (24, 0, 0, 0, 0)),
                              ("whisper-base", (6, 0, 0, 0, 0)),
                              ("llama-3.2-vision-11b", (40, 0, 0, 0, 0)))]
# the paths whose traffic is not (BATCH, PROMPT): h2o-danube-3-4b serves a
# prompt of 6,144 tokens, past its 4,096-token window, at batch 2
SERVE_SHAPES = {"h2o-danube-3-4b": (2, 6144)}
# decode steps of the bf16 decode-vs-prefill check: h2o-danube's each
# write a ring slot over the oldest position
DECODE_CHECK_STEPS = {"h2o-danube-3-4b": 3}
# that check's bound in units of the logits' standard deviation (0.25
# unless named; see ``phase_serve``).  llama-3.2-vision-11b rounds bf16
# activations through 48 blocks (40 layers, 8 cross blocks) over 4 x
# 128,256 logits, where olmo-1b's 0.25 was set on 16 layers and 4 x 50,304:
# its first run on a card read a max |diff| of 0.382 against 0.25 std =
# 0.320, with a mean |diff| of 0.061 (a fault of structure moves logits by
# their own spread, about 1.28).  Its bound is 0.5 std; the structural
# check is the f32 one at full width in phase 3b (2e-3), which it passes.
DECODE_BF16_BOUND = {"llama-3.2-vision-11b": 0.5}

# olmo-1b training: logical world 4, global batch 4 x 4096 (the repo's
# train_4k shape, batch cut from 256 to fit one card); 3 steps at 4
# physical devices, then resize(2) and 2 steps at splice 2
TRAIN = dict(world=4, batch=4, seq=4096, physical=(4, 4, 4, 2, 2))
TRAIN_PATH = "olmo-1b train"
# Kernel path against plain path on the first batch, bf16: about 10x the
# readings on an H100 (loss 8.8e-6, grad_norm 1.0e-5 relative).  This check
# is weak on the attention, a small term of the residual at 0.02-scale
# init; phase 2 holds swa_flash itself at the training shapes.
TRAIN_TOL = dict(loss=1e-4, grad_norm=1e-4)
SSM_TRAIN_PATH = "mamba2-130m-train"
HYBRID_TRAIN_PATH = "zamba2-1.2b-train"
MOE_TRAIN_PATH = "granite-moe-train"
AUDIO_TRAIN_PATH = "whisper-base-train"
VLM_TRAIN_PATH = "vlm-train"
# granite-moe-3b-a800m trains at all 32 layers (3.37 B parameters) with
# the donated step (``donate``): params, m and v updated in place and one
# gradient sum, 16 bytes a parameter (54 GB), where the functional step
# holds 28 at its update (94 GB, more than the card)
# Each training path: its kernels' launches per slice (remat runs each
# layer's forward twice), its gradient leaves, the bounds of its first
# loss (about ln V + sigma^2 / 2 with sigma^2 = d * 0.02^2: from ln V to
# 0.36 above that) and of its kernel path against its plain path.  For
# mamba2 the bounds were set before its first run on a card: the SSD
# kernel is every layer's core (where attention was a small term of
# olmo's residual), and its y rounds to bf16 after a sum that differs
# from the plain version's by up to 1e-4, so a grad_norm bound 10x olmo's.
# ``f32_firm`` is phase 4b's / 6b's rule for the AdamW entries held to 1e-3
# lr (see ``phase_train_f32``).  ``layers`` cuts the depth (0: the
# config's), ``copies_per_slice`` the operands a wrapper copies for TMA
# on each slice, ``check_layers`` and ``check_dtype`` the depth and dtype
# of the splice check (zamba2: one group and a tail layer, so the shared
# block runs; llama-vision: one group), ``check_donate`` whether it
# donates.  zamba2's and granite's bounds were set before their first
# run on a card: granite's first loss adds the aux loss, 0.01 E sum_e f_e
# p_e with E = 48 padded experts, 0.012 a layer were the 40 real ones
# used evenly.  whisper-base's were set before its first run on a card
# too: its cross gates are set to [0.3, 0.9) (``gates``), which moves the
# loss by a few hundredths at most from ln V + sigma^2 / 2 = 10.959; its
# (512, 51865) head is copied for TMA on every slice, as granite's.
TRAIN_SPECS = {
    TRAIN_PATH: dict(arch="olmo-1b", phase="4",
                     per_slice={"swa_flash": 32, "swa_flash_bwd": 16,
                                "fused_ce_stats": 1},
                     leaves=8, named=(), first_loss=(10.83, 11.6),
                     tol=TRAIN_TOL, f32_firm="|g| >= 1e-6"),
    HYBRID_TRAIN_PATH: dict(arch="zamba2-1.2b", phase="8",
                            per_slice={"ssd_intra_chunk": 76,
                                       "swa_flash": 12, "swa_flash_bwd": 6,
                                       "fused_ce_stats": 1},
                            leaves=21, named=("blocks/ssm/A_log",
                                              "shared_attn/attn/wq",
                                              "shared_attn/mlp/wg", "head"),
                            first_loss=(10.37, 11.15),
                            tol=dict(loss=1e-4, grad_norm=1e-3),
                            f32_firm="the gradients agree to 1e-3 relative",
                            check_layers=7),
    MOE_TRAIN_PATH: dict(arch="granite-moe-3b-a800m", phase="9",
                         donate=True,
                         per_slice={"swa_flash": 64, "swa_flash_bwd": 32,
                                    "fused_ce_stats": 1},
                         copies_per_slice={"fused_ce_stats": 1},
                         leaves=13, named=("blocks/moe/router",
                                           "blocks/moe/wi", "blocks/moe/wg",
                                           "blocks/moe/wo", "head"),
                         first_loss=(10.80, 11.47 + 0.0125 * 32),
                         tol=dict(loss=1e-4, grad_norm=1e-3),
                         f32_firm="the gradients agree to 1e-3 relative",
                         check_dtype="float32"),
    AUDIO_TRAIN_PATH: dict(arch="whisper-base", phase="10",
                           per_slice={"swa_flash": 12, "swa_flash_bwd": 6,
                                      "fused_ce_stats": 1},
                           copies_per_slice={"fused_ce_stats": 1},
                           leaves=33, named=("cross/gate", "cross/attn/wk",
                                             "encoder/blocks/attn/wq",
                                             "encoder/final_norm/scale",
                                             "head"),
                           first_loss=(10.85, 11.35),
                           tol=dict(loss=1e-4, grad_norm=1e-3),
                           f32_firm="the gradients agree to 1e-3 relative",
                           gates=True),
    # llama-3.2-vision-11b at full width and 5 of its 40 layers (one group
    # of 5 with its cross block, 2,188,378,112 parameters) with the donated
    # step, 16 bytes a parameter (35.0 GB; the whole model needs 162 GB):
    # 10 ``swa_flash`` (5 layers, again in the group's remat) and 1
    # ``fused_ce_stats`` per slice, the (4096, 128256) head read in place.
    # 10 layers (two groups, 53.1 GB) do not fit: a group's recompute at
    # 16,384 tokens holds about 36 GB beside the state and the gradient
    # sum (the planner's trace of that step on one device, ``dryrun
    # --layers 10 --global-batch 4 --mesh-shape 1,1 --donate``: 89.0 GB),
    # and such a run on an H100 ran out of memory in the second group's
    # cross block.  Its bounds were set
    # before its first run on a card: ln V + sigma^2 / 2 = 11.762 + 0.819 =
    # 12.581 at d 4096, the gates moving it by a few hundredths at most.
    # Its splice check runs the same group donated, each splice factor from
    # its own state made from the seed: two copies of one state would not
    # fit beside a step.
    VLM_TRAIN_PATH: dict(arch="llama-3.2-vision-11b", phase="12", layers=5,
                         donate=True,
                         per_slice={"swa_flash": 10, "swa_flash_bwd": 5,
                                    "fused_ce_stats": 1},
                         leaves=19, named=("cross/gate", "cross/attn/wk",
                                           "projector", "head"),
                         first_loss=(12.2, 12.95),
                         tol=dict(loss=1e-4, grad_norm=1e-3),
                         f32_firm="the gradients agree to 1e-3 relative",
                         gates=True, check_layers=5, check_donate=True),
    SSM_TRAIN_PATH: dict(arch="mamba2-130m", phase="6",
                         per_slice={"ssd_intra_chunk": 48,
                                    "fused_ce_stats": 1},
                         leaves=11, named=("blocks/ssm/A_log",
                                           "blocks/ssm/D",
                                           "blocks/ssm/dt_bias",
                                           "blocks/ssm/conv_w"),
                         first_loss=(10.82, 11.34),
                         tol=dict(loss=1e-4, grad_norm=1e-3),
                         f32_firm="the gradients agree to 1e-3 relative"),
}
# each rule: (beta1, m on the CPU, m on the card) -> the firm entries
F32_FIRM = {
    "|g| >= 1e-6": lambda beta1, m, m_card: np.abs(m) / (1 - beta1) >= 1e-6,
    "the gradients agree to 1e-3 relative":
        lambda beta1, m, m_card: np.abs(m_card - m) <= 1e-3 * np.abs(m),
}

# fingerprint_u32 vs plain version, bit for bit: (shape, dtype name)
FP_CASES = [
    ((1000,), "float32"), ((64, 128), "bfloat16"), ((7, 11, 13), "int32"),
    ((100_000,), "float32"), ((3, 5), "float32"), ((256, 128), "uint8"),
    ((4096, 7), "bfloat16"), ((33, 7), "float16"), ((40_000,), "float32"),
    ((3000,), "int64"), ((1 << 20,), "float32"),
    ((16, 2048, 8192), "float32"),   # olmo-1b's opt/m/blocks/mlp/wg
]
FP_TIMED = [(1 << 20,), (16, 2048, 8192)]
MIGRATE_PATH = "olmo-1b-migrate"
# torch.cuda.memory_allocated() after each training path's setup: its state
STATE_BYTES = {}
# each training path's largest step peak (torch.cuda.max_memory_allocated)
# at each splice factor
PEAK_BYTES = {}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, name: str, iters: int) -> float:
    """Device time per call of ``fn()`` of the kernels whose name holds
    ``name``, from ``torch.profiler`` over ``iters`` calls: the kernels'
    own time, without the host's launch overhead that back-to-back events
    also see when a call's Python outlasts its kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if name in e.key)
    if total <= 0:
        raise AssertionError(f"the profiler saw no {name} kernel")
    return total / 1e3 / iters


def time_ms_l2_flushed(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` with a cold L2: a 64 MB buffer is
    written before each call, and the mean time of writing it alone is
    subtracted."""
    buf = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")

    def flushed():
        buf.zero_()
        fn()

    both = time_ms(torch, flushed, iters, warmup)
    return both - time_ms(torch, buf.zero_, iters, warmup)


def _peak_flops(torch, dtype):
    from repro_torch.utils import constants

    return {torch.bfloat16: constants.DATASHEET_PEAK_BF16_FLOPS,
            torch.float32: constants.DATASHEET_PEAK_F32_FLOPS}[dtype]


def _bound(t_bytes: float, t_ops: float):
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _dtype_bound(torch, cost, dtype):
    """(ms, "bytes" | "operations") of a kernel's ``KernelCost``: its bytes
    over the HBM rate against its flops over the dense peak of ``dtype``
    (H100 SXM data sheet)."""
    from repro_torch.utils import constants

    return _bound(cost.bytes / constants.DATASHEET_HBM_BANDWIDTH,
                  cost.flops / _peak_flops(torch, dtype))


def attention_bound(torch, b, s, h, d, window, dtype):
    """Least time for ``swa_flash`` on an H100 SXM (data sheet), from the
    op's formula (``swa_attention/ops.py::swa_flash_cost``): q, k, v read
    once and o written once, against 2 products of 2 flops per kept
    (query, key) pair and head dim."""
    from repro_torch.kernels.swa_attention.ops import swa_flash_cost

    elsize = torch.empty((), dtype=dtype).element_size()
    return _dtype_bound(torch, swa_flash_cost(b, s, h, d, window, elsize),
                        dtype)


def ssd_bound(torch, bc, q, h, p, n, dtype):
    """Least time for ``ssd_intra_chunk`` on an H100 SXM (data sheet), from
    the op's formula (``ssd_scan/ops.py::ssd_intra_chunk_cost``)."""
    from repro_torch.kernels.ssd_scan.ops import ssd_intra_chunk_cost

    elsize = torch.empty((), dtype=dtype).element_size()
    return _dtype_bound(torch, ssd_intra_chunk_cost(bc, q, h, p, n, elsize),
                        dtype)


def attention_bwd_bound(torch, b, s, h, d, window):
    """Least time for ``swa_flash_bwd`` in bf16 on an H100 SXM (data
    sheet), from the op's formula (``swa_attention/ops.py::
    swa_flash_bwd_cost``: its five products, the recomputed Q K^T among
    them), and (ms, by) of the least work alone: the four products dV, dP,
    dQ, dK, as ``bench/costs.py::attention_bwd`` counts them."""
    from repro_torch.kernels.swa_attention.ops import swa_flash_bwd_cost

    cost = swa_flash_bwd_cost(b, s, h, d, window, 2)
    least = cost._replace(flops=cost.flops * 4 // 5)
    return (_dtype_bound(torch, cost, torch.bfloat16),
            _dtype_bound(torch, least, torch.bfloat16))


def _opcheck(torch, name, args):
    """``torch.library.opcheck`` of ``repro_torch::<name>`` on CUDA inputs:
    its schema, and its fake implementation's outputs against the kernel's
    (shapes, dtypes, strides).  Raises on a failure.  Its launches are
    checks, outside every path's count."""
    op = getattr(torch.ops.repro_torch, name).default
    result = torch.library.opcheck(
        op, args, test_utils=("test_schema", "test_faketensor"))
    shapes = [tuple(a.shape) if hasattr(a, "shape") else a for a in args]
    print(f"opcheck repro_torch::{name} on CUDA inputs {shapes}: {result}",
          flush=True)
    if set(result.values()) != {"SUCCESS"}:
        raise AssertionError(f"opcheck of {name}: {result}")


def phase_kernel(torch, swa_attention, swa_attention_ref):
    print("\n== phase 2: swa_flash against its plain version on the card",
          flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    main_err = None
    for b, s, h, d, w, dname in KERNEL_CASES:
        dtype = getattr(torch, dname)
        q, k, v = (torch.randn(b, s, h, d, generator=gen, device=dev)
                   .to(dtype) for _ in range(3))
        got = swa_attention(q, k, v, window=w)
        torch.cuda.synchronize()
        want = swa_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), window=w).transpose(1, 2)
        if not torch.isfinite(got).all():
            raise AssertionError(f"non-finite kernel output at {(b, s, h, d, w)}")
        err = (got.float() - want.float()).abs().max().item()
        tol = TOLERANCE[dname]
        torch.testing.assert_close(got.float(), want.float(), **tol)
        print(f"B={b} S={s} H={h} D={d} window={w} {dname}: max |kernel - "
              f"plain| = {err!r} within rtol={tol['rtol']!r} "
              f"atol={tol['atol']!r}", flush=True)
        if main_err is None:
            main_err = err
    b, s, h, d, w, dname = KERNEL_CASES[0]
    _opcheck(torch, "swa_flash", (*(
        torch.randn(b, s, h, d, generator=gen, device=dev)
        .to(getattr(torch, dname)) for _ in range(3)), w))

    sdpa = torch.nn.functional.scaled_dot_product_attention
    stats = dict(max_abs_err=main_err)
    for case, key, iters in SWA_TIMED:
        b, s, h, d, w, dname = case
        # SDPA's is_causal is the mask where the window is 0 or S; a
        # shorter window goes in as a boolean (S, S) mask (True: attend)
        sdpa_kw = dict(is_causal=True)
        if 0 < w < s:
            pos = torch.arange(s, device=dev)
            sdpa_kw = dict(attn_mask=(pos[None, :] <= pos[:, None])
                           & (pos[None, :] > pos[:, None] - w))
        dtype = getattr(torch, dname)
        q, k, v = (torch.randn(b, s, h, d, generator=gen, device=dev)
                   .to(dtype) for _ in range(3))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        kernel_ms = time_ms(torch, lambda: swa_attention(q, k, v, window=w),
                            iters)
        plain_ms = time_ms(torch, lambda: swa_attention_ref(qt, kt, vt,
                                                            window=w),
                           max(3, iters // 10), 1)
        library_ms = time_ms(torch, lambda: sdpa(qt, kt, vt, **sdpa_kw),
                             iters)
        kernel_ms_2 = time_ms(torch, lambda: swa_attention(q, k, v, window=w),
                              iters)
        cold_ms = time_ms_l2_flushed(
            torch, lambda: swa_attention(q, k, v, window=w), iters)
        dev_ms = device_ms(torch, lambda: swa_attention(q, k, v, window=w),
                           "swa_flash", iters)
        bound_ms, bound_by = attention_bound(torch, b, s, h, d, w, dtype)
        print(f"times at B={b} S={s} H={h} D={d} window={w} {dname} (mean of "
              f"back-to-back launches; q/k/v/o "
              f"{4 * q.numel() * q.element_size()} bytes): kernel "
              f"{kernel_ms!r} ms then {kernel_ms_2!r} ms, with the L2 flushed"
              f" before each launch {cold_ms!r} ms, device time by the "
              f"profiler {dev_ms!r} ms; plain {plain_ms!r} ms, "
              f"scaled_dot_product_attention {library_ms!r} ms, bound "
              f"{bound_ms!r} ms ({bound_by})", flush=True)
        stats.update({f"ms{key}": (kernel_ms + kernel_ms_2) / 2,
                      f"ms{key}_l2_flushed": cold_ms,
                      f"ms{key}_device": dev_ms,
                      f"plain_ms{key}": plain_ms,
                      f"bound_ms{key}": bound_ms,
                      f"bound_by{key}": bound_by,
                      f"library_ms{key}": library_ms})
        del q, k, v, qt, kt, vt, sdpa_kw
        torch.cuda.empty_cache()
    return stats


def phase_bwd_kernel(torch, swa_flash, swa_flash_bwd, swa_attention_bwd_ref):
    print("\n== phase 2e: swa_flash_bwd against the plain backward on the "
          "card", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def inputs(b, s, h, d, w):
        q, k, v, do = (torch.randn(b, s, h, d, generator=gen, device=dev)
                       .to(torch.bfloat16) for _ in range(4))
        o, lse = swa_flash(q, k, v, window=w)
        return q, k, v, o, do, lse

    stats = {}
    for b, s, h, d, w in BWD_CASES:
        q, k, v, o, do, lse = inputs(b, s, h, d, w)
        before = swa_flash_bwd.launches
        got = swa_flash_bwd(q, k, v, o, do, lse, window=w)
        torch.cuda.synchronize()
        if swa_flash_bwd.launches != before + 1:
            raise AssertionError("swa_flash_bwd did not count its launch")
        want = swa_attention_bwd_ref(q, k, v, do, w)
        errs = []
        for name, a, r in zip(("dq", "dk", "dv"), got, want):
            if not torch.isfinite(a).all():
                raise AssertionError(f"non-finite {name} at {(b, s, h, d, w)}")
            scale = r.float().abs().max().item()
            errs.append((a.float() - r.float()).abs().max().item() / scale)
        print(f"B={b} S={s} H={h} D={d} window={w}: max |kernel - plain| / "
              f"max |plain| of dq, dk, dv = {errs!r} (bound {BWD_TOL})",
              flush=True)
        if max(errs) > BWD_TOL:
            raise AssertionError("swa_flash_bwd disagrees with the plain "
                                 "backward")
        stats.setdefault("max_abs_err", max(errs))
        del q, k, v, o, do, lse, got, want
    b, s, h, d, w = BWD_CASES[5]
    _opcheck(torch, "swa_flash_bwd", (*inputs(b, s, h, d, w), w))

    for case, key, iters in BWD_TIMED:
        b, s, h, d, w = case
        q, k, v, o, do, lse = inputs(*case)
        fn = lambda: swa_flash_bwd(q, k, v, o, do, lse, window=w)  # noqa: E731
        kernel_ms = time_ms(torch, fn, iters)
        plain_ms = time_ms(torch, lambda: swa_attention_bwd_ref(q, k, v, do, w),
                           max(3, iters // 10), 1)
        kernel_ms_2 = time_ms(torch, fn, iters)
        dev_ms = device_ms(torch, fn, "bwd_", iters)
        (bound_ms, bound_by), (least_ms, _) = attention_bwd_bound(
            torch, b, s, h, d, w)
        print(f"times at B={b} S={s} H={h} D={d} window={w} bfloat16 (mean of "
              f"back-to-back calls of the three kernels): swa_flash_bwd "
              f"{kernel_ms!r} ms then {kernel_ms_2!r} ms, device time by the "
              f"profiler {dev_ms!r} ms; plain backward {plain_ms!r} ms; bound "
              f"{bound_ms!r} ms ({bound_by}, the op's five products), "
              f"{least_ms!r} ms for the four of the least work; no PyTorch "
              f"call the port may use computes it", flush=True)
        stats.update({f"ms{key}": (kernel_ms + kernel_ms_2) / 2,
                      f"ms{key}_device": dev_ms,
                      f"plain_ms{key}": plain_ms,
                      f"bound_ms{key}": bound_ms,
                      f"bound_by{key}": bound_by,
                      f"least_work_ms{key}": least_ms})
        del q, k, v, o, do, lse
        torch.cuda.empty_cache()
    stats.update(ms=stats["ms_train"], plain_ms=stats["plain_ms_train"],
                 bound_ms=stats["bound_ms_train"],
                 bound_by=stats["bound_by_train"], library_ms=None)
    return stats


def _ssd_inputs(torch, gen, bs, l, h, p, n, dtype):
    """x, dt, a, b, c on the card, drawn as tests/test_kernels.py draws
    them (standard normal x, b, c; dt = softplus(normal); a near -1)."""
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    x = randn(bs, l, h, p).to(dtype)
    dt = torch.nn.functional.softplus(randn(bs, l, h))
    a = -torch.exp(0.1 * randn(h))
    return x, dt, a, randn(bs, l, n).to(dtype), randn(bs, l, n).to(dtype)


def phase_ssd_kernel(torch, ssd_intra_chunk, ssd_chunked, ref):
    print("\n== phase 2b: ssd_intra_chunk against its plain version on the "
          "card", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    main_err = None
    for bc, q, h, p, n, dname in SSD_CASES:
        inputs = _ssd_inputs(torch, gen, bc, q, h, p, n, getattr(torch, dname))
        got = ssd_intra_chunk(*inputs)
        torch.cuda.synchronize()
        want = ref.ssd_intra_chunk_ref(*inputs)
        errs = []
        for name, g, w in zip(("y_intra", "states", "cum"), got, want):
            if not torch.isfinite(g).all():
                raise AssertionError(f"non-finite {name} at {(bc, q, h, p, n)}")
            torch.testing.assert_close(g, w, **SSD_TOL)
            errs.append((g - w).abs().max().item())
        print(f"BC={bc} Q={q} H={h} P={p} N={n} {dname}: max |kernel - "
              f"plain| y_intra {errs[0]!r}, states {errs[1]!r}, cum "
              f"{errs[2]!r}, within rtol=atol=1e-4", flush=True)
        if main_err is None:
            main_err = max(errs)
    bc, q, h, p, n, dname = SSD_CASES[0]
    _opcheck(torch, "ssd_intra_chunk", _ssd_inputs(
        torch, gen, bc, q, h, p, n, getattr(torch, dname)))

    # the whole wrapper at a ragged length: against the plain chunked scan
    # (1e-4), the O(L) recurrence (1e-3, tests/test_kernels.py) and its own
    # continuation from a carried state (1e-4)
    bs, l, h, p, n, chunk = SSD_RAGGED
    x, dt, a, b, c = _ssd_inputs(torch, gen, bs, l, h, p, n, torch.float32)
    y, final = ssd_chunked(x, dt, a, b, c, chunk)
    y_ref, s_ref = ref.ssd_chunked_ref(x, dt, a, b, c, chunk)
    torch.testing.assert_close(y, y_ref, **SSD_TOL)
    torch.testing.assert_close(final, s_ref, **SSD_TOL)
    y_seq, s_seq = ref.ssd_sequential_ref(x, dt, a, b, c)
    torch.testing.assert_close(y, y_seq, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(final, s_seq, rtol=1e-3, atol=1e-3)
    half = 96
    y1, s1 = ssd_chunked(x[:, :half], dt[:, :half], a, b[:, :half],
                         c[:, :half], chunk)
    y2, s2 = ssd_chunked(x[:, half:], dt[:, half:], a, b[:, half:],
                         c[:, half:], chunk, initial_state=s1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, **SSD_TOL)
    torch.testing.assert_close(s2, final, **SSD_TOL)
    print(f"wrapper at B={bs} L={l} H={h} P={p} N={n} chunk={chunk} f32: max "
          f"|y - plain chunked| {(y - y_ref).abs().max().item()!r} (1e-4), "
          f"|y - recurrence| {(y - y_seq).abs().max().item()!r} (1e-3), "
          f"continuation from the state at {half}: max |diff| "
          f"{(torch.cat([y1, y2], 1) - y).abs().max().item()!r} (1e-4)",
          flush=True)

    # times at the mamba2 serving shape (the kernels line's ms) and the
    # others of SSD_TIMED, under their suffixes
    stats = dict(max_abs_err=main_err, library_ms=None)
    for case, suffix in SSD_TIMED:
        timed = _time_ssd(torch, gen, ssd_intra_chunk, ref, case)
        stats.update({f"{key}{suffix}": val for key, val in timed.items()})
    return stats


def _time_ssd(torch, gen, ssd_intra_chunk, ref, case):
    bc, q, h, p, n, dname = case
    dtype = getattr(torch, dname)
    inputs = _ssd_inputs(torch, gen, bc, q, h, p, n, dtype)
    kernel_ms = time_ms(torch, lambda: ssd_intra_chunk(*inputs), 100)
    plain_ms = time_ms(torch, lambda: ref.ssd_intra_chunk_ref(*inputs), 10)
    kernel_ms_2 = time_ms(torch, lambda: ssd_intra_chunk(*inputs), 100)
    kernel = "ssd_bf16_kernel" if dname == "bfloat16" else "ssd_f32_kernel"
    dev_ms = device_ms(torch, lambda: ssd_intra_chunk(*inputs), kernel, 100)
    bound_ms, bound_by = ssd_bound(torch, bc, q, h, p, n, dtype)
    print(f"times at BC={bc} Q={q} H={h} P={p} N={n} {dname} (mean of "
          f"back-to-back launches): kernel {kernel_ms!r} ms then "
          f"{kernel_ms_2!r} ms, device time by the profiler {dev_ms!r} ms; "
          f"plain {plain_ms!r} ms, bound {bound_ms!r} ms ({bound_by}); no "
          f"PyTorch call computes this function", flush=True)
    return dict(ms=(kernel_ms + kernel_ms_2) / 2, ms_device=dev_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


def ce_bound(torch, t, d, v, dtype):
    """Least time for ``fused_ce_stats`` on an H100 SXM (data sheet), from
    the op's formula (``fused_ce/ops.py::fused_ce_stats_cost``): hidden,
    head and int32 labels read once, lse and pick written once, against
    2 T d V flops."""
    from repro_torch.kernels.fused_ce.ops import fused_ce_stats_cost

    elsize = torch.empty((), dtype=dtype).element_size()
    return _dtype_bound(torch, fused_ce_stats_cost(t, d, v, elsize), dtype)


def _ce_inputs(torch, gen, t, d, v, dtype, tied):
    """hidden ~ N(0, 1), head ~ 0.02 N(0, 1) (the embedding's init scale),
    as ``embed.T`` when ``tied``; labels in [-1, V)."""
    h = torch.randn(t, d, generator=gen, device="cuda").to(dtype)
    if tied:
        w = (0.02 * torch.randn(v, d, generator=gen, device="cuda")).to(dtype).T
    else:
        w = (0.02 * torch.randn(d, v, generator=gen, device="cuda")).to(dtype)
    lab = torch.randint(-1, v, (t,), generator=gen, device="cuda")
    return h, w, lab


def fingerprint_bound(n_words: int):
    """Least time for ``fingerprint_u32`` on an H100 SXM, from the op's
    formula (``checksum/ops.py::fingerprint_u32_cost``): the words read
    once and the 16-byte digest written once over the HBM rate, against
    its 32-bit integer instructions over the integer multiply-add rate.
    Returns (ms, "bytes" | "operations")."""
    from repro_torch.kernels.checksum.ops import fingerprint_u32_cost
    from repro_torch.utils import constants

    cost = fingerprint_u32_cost(n_words)
    return _bound(cost.bytes / constants.DATASHEET_HBM_BANDWIDTH,
                  cost.int_ops / constants.DATASHEET_INT32_OPS)


def _fp_input(torch, gen, shape, dname):
    dtype = getattr(torch, dname)
    if dtype.is_floating_point:
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    hi = 256 if dtype == torch.uint8 else 2 ** 31 - 1
    x = torch.randint(0, hi, shape, generator=gen, device="cuda").to(dtype)
    return x * (2 ** 20) - 7 if dtype == torch.int64 else x


def phase_fingerprint_kernel(torch, fingerprint_u32, fp_ops, fp_ref):
    print("\n== phase 2d: fingerprint_u32 against its plain version on the "
          "card, bit for bit", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def check(x, label):
        before = fingerprint_u32.launches
        got = fp_ops.fingerprint(x)
        torch.cuda.synchronize()
        if fingerprint_u32.launches != before + 1:
            raise AssertionError(f"{label}: the kernel did not launch once")
        want = fp_ref.fingerprint_u32_ref(fp_ops._as_words(x))
        if got.dtype != torch.uint32 or got.shape != (4,):
            raise AssertionError(f"{label}: digest {got.dtype} {got.shape}")
        err = (got.to(torch.int64) - want.to(torch.int64)).abs().max().item()
        print(f"{label}: kernel {got.tolist()} plain {want.tolist()}, max "
              f"|diff| {err}", flush=True)
        if err != 0:
            raise AssertionError(f"{label}: the kernel and the plain version "
                                 f"differ")
        return err

    worst = 0
    for shape, dname in FP_CASES:
        x = _fp_input(torch, gen, shape, dname)
        worst = max(worst, check(x, f"{shape} {dname}"))
        if shape == (40_000,):
            # a view 4 bytes into the buffer: not 16-byte aligned, so the
            # kernel takes its scalar loads
            worst = max(worst, check(x[1:], f"{shape} {dname} [1:] view"))
        del x
    shape, dname = FP_CASES[0]
    _opcheck(torch, "fingerprint_u32",
             (fp_ops._flat_words(_fp_input(torch, gen, shape, dname)),))
    torch.cuda.empty_cache()

    times = {}
    for shape in FP_TIMED:
        x = _fp_input(torch, gen, shape, "float32")
        words = fp_ops._flat_words(x)
        padded = fp_ops._as_words(x)
        n = words.numel()
        iters = 200 if n < 1 << 24 else 20
        kernel_ms = time_ms(torch, lambda: fp_ops.fingerprint(x), iters)
        plain_ms = time_ms(torch, lambda: fp_ref.fingerprint_u32_ref(padded),
                           max(2, iters // 20), 1)
        sum_ms = time_ms(torch, lambda: words.view(torch.int32).sum(), iters)
        kernel_ms_2 = time_ms(torch, lambda: fp_ops.fingerprint(x), iters)
        bound_ms, bound_by = fingerprint_bound(n)
        print(f"times at {shape} f32 ({4 * n} bytes; mean of back-to-back "
              f"launches): kernel {kernel_ms!r} ms then {kernel_ms_2!r} ms "
              f"({4 * n / (kernel_ms / 1e3) / 1e12!r} TB/s), plain "
              f"{plain_ms!r} ms, torch.sum over the int32 words {sum_ms!r} "
              f"ms, bound {bound_ms!r} ms ({bound_by})", flush=True)
        times[shape] = dict(ms=(kernel_ms + kernel_ms_2) / 2,
                            plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by, library_ms=sum_ms)
        del x, words, padded
        torch.cuda.empty_cache()
    # the kernels line: olmo-1b's largest leaf, the main path's costliest
    return dict(times[FP_TIMED[-1]], max_abs_err=worst)


def phase_ce_kernel(torch, ce, ce_ref, fused_cross_entropy):
    print("\n== phase 2c: fused_ce_stats against its plain version on the "
          "card", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    main_err = None
    for t, d, v, dname, tied in CE_CASES:
        dtype = getattr(torch, dname)
        h, w, lab = _ce_inputs(torch, gen, t, d, v, dtype, tied)
        copies = ce.fused_ce_stats.copies
        lse, pick = ce.fused_ce_stats(h, w, lab)
        torch.cuda.synchronize()
        copies = ce.fused_ce_stats.copies - copies
        # TMA (the bf16 path) reads a head in place when a stride is 1 and
        # the other a multiple of 8 elements; an untied (d, V) head with V
        # no multiple of 8 is copied once
        want_copies = int(dname == "bfloat16" and not tied and v % 8 != 0)
        if copies != want_copies:
            raise AssertionError(f"{copies} head copies at {(t, d, v)}, "
                                 f"expected {want_copies}")
        want_lse, want_pick = ce_ref.fused_ce_stats_ref(h, w, lab)
        for name, got, want in (("lse", lse, want_lse),
                                ("pick", pick, want_pick)):
            if not torch.isfinite(got).all():
                raise AssertionError(f"non-finite {name} at {(t, d, v)}")
            torch.testing.assert_close(got, want, **CE_TOL)
        if not (pick[lab < 0] == -1e30).all():
            raise AssertionError("a label < 0 picked a logit")
        with torch.no_grad():
            loss, count = fused_cross_entropy(h, w, lab)
        want_loss, want_count = ce_ref.cross_entropy_ref(h, w, lab)
        if count.item() != want_count.item():
            raise AssertionError(f"count {count.item()} != {want_count.item()}")
        torch.testing.assert_close(loss, want_loss, rtol=1e-5, atol=0)
        errs = [(lse - want_lse).abs().max().item(),
                (pick - want_pick)[lab >= 0].abs().max().item()]
        print(f"T={t} d={d} V={v} {dname}, head "
              f"{'embed.T' if tied else '(d, V)'} ({copies} copied for "
              f"TMA): max |lse - plain| "
              f"{errs[0]!r}, max |pick - plain| {errs[1]!r} (rtol 1e-5, "
              f"atol 1e-4); fused_cross_entropy (sum, count) "
              f"({loss.item()!r}, {count.item()!r}), full-logits plain sum "
              f"{want_loss.item()!r}, diff {(loss - want_loss).item()!r} "
              f"(rtol 1e-5), count diff 0", flush=True)
        if main_err is None:
            main_err = max(errs)
        del h, w, lab, want_lse, want_pick
    t, d, v, dname, tied = CE_CASES[0]
    _opcheck(torch, "fused_ce_stats",
             _ce_inputs(torch, gen, t, d, v, getattr(torch, dname), tied))

    times = {}
    for (t, d, v, dname, tied), suffix in CE_TIMED:
        dtype = getattr(torch, dname)
        h, w, lab = _ce_inputs(torch, gen, t, d, v, dtype, tied)
        gemm_ms = time_ms(torch, lambda: h @ w, 10)
        kernel_ms = time_ms(torch, lambda: ce.fused_ce_stats(h, w, lab), 10)
        plain_ms = time_ms(torch, lambda: ce_ref.fused_ce_stats_ref(h, w, lab),
                           3, 1)
        kernel_ms_2 = time_ms(torch, lambda: ce.fused_ce_stats(h, w, lab), 10)
        cold_ms = time_ms_l2_flushed(
            torch, lambda: ce.fused_ce_stats(h, w, lab), 10)
        bound_ms, bound_by = ce_bound(torch, t, d, v, dtype)
        print(f"context: cuBLAS h @ W at T={t} ({dname} GEMM, (T, V) {dname} "
              f"out): {gemm_ms!r} ms", flush=True)
        print(f"times at T={t} d={d} V={v} {dname} (mean of back-to-back "
              f"launches): kernel {kernel_ms!r} ms then {kernel_ms_2!r} ms, "
              f"with the L2 flushed before each launch {cold_ms!r} ms; plain "
              f"{plain_ms!r} ms, bound {bound_ms!r} ms ({bound_by}); "
              f"library: none (no PyTorch call computes (lse, pick))",
              flush=True)
        times.update({f"{key}{suffix}": val for key, val in dict(
            ms=(kernel_ms + kernel_ms_2) / 2, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, ms_l2_flushed=cold_ms,
            gemm_ms=gemm_ms).items()})
        del h, w, lab
        torch.cuda.empty_cache()
    # the kernels line's ms: olmo-1b at splice 1 (no suffix)
    return dict(times, max_abs_err=main_err, library_ms=None)


@contextlib.contextmanager
def plain_versions():
    """Run the model with the kernels' plain versions on the card: the
    comparison of the kernel path with the plain path, and nothing else.
    The kernels' wrappers are swapped out where the ops' CUDA
    implementations call them, so their launch counts stay as they
    were."""
    import torch

    from repro_torch.kernels.fused_ce import ops as ce_ops
    from repro_torch.kernels.fused_ce.ref import fused_ce_stats_ref
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.ref import ssd_intra_chunk_ref
    from repro_torch.kernels.swa_attention import ops as swa_ops
    from repro_torch.kernels.swa_attention.ref import (swa_attention_bwd_ref,
                                                       swa_attention_lse_ref)

    def swa_plain(q, k, v, *, window):
        # one batch row at a time, as the plain backward runs: the (H, S, S)
        # f32 scores of one row bound its memory (llama-3.2-vision's 32
        # heads at S 4096: 2.1 GB a buffer, 8.6 GB for a batch of 4)
        rows = [swa_attention_lse_ref(
            *(t[i:i + 1].transpose(1, 2) for t in (q, k, v)), window=window)
            for i in range(q.shape[0])]
        return (torch.cat([o.transpose(1, 2) for o, _ in rows]),
                torch.cat([lse for _, lse in rows]))

    def swa_bwd_plain(q, k, v, o, dout, lse, *, window):
        return swa_attention_bwd_ref(q, k, v, dout, window)

    names = ((ce_ops, "fused_ce_stats", fused_ce_stats_ref),
             (swa_ops, "swa_flash", swa_plain),
             (swa_ops, "swa_flash_bwd", swa_bwd_plain),
             (ssd_ops, "ssd_intra_chunk", ssd_intra_chunk_ref))
    saved = [getattr(module, name) for module, name, _ in names]
    for module, name, plain in names:
        setattr(module, name, plain)
    try:
        yield
    finally:
        for (module, name, _), fn in zip(names, saved):
            setattr(module, name, fn)


def _first_batch_grads(torch, rt, loss_and_grads, global_norm):
    """Loss, grad_norm and per-leaf gradient norms of the runtime's state on
    its first batch (the cursor is not moved)."""
    tokens, labels = rt.pipeline.batch_for_ranks(range(rt.world_size),
                                                 step=0)
    batch = {"tokens": torch.as_tensor(tokens, device="cuda").long(),
             "labels": torch.as_tensor(labels, device="cuda").long(),
             **rt.extra_inputs}
    loss, grads = loss_and_grads(rt.state["params"], batch, rt.cfg, rt.tcfg)
    norms = {}

    def walk(tree, path):
        if isinstance(tree, dict):
            for key, val in tree.items():
                walk(val, f"{path}/{key}" if path else key)
        elif tree is not None:
            norms[path] = tree.float().norm().item()

    walk(grads, "")
    out = loss.item(), global_norm(grads).item(), norms
    del grads
    torch.cuda.empty_cache()
    return out


def phase_train(torch, card, counters, path=TRAIN_PATH):
    """Training at full width through ElasticRuntime, the path ``path`` of
    ``TRAIN_SPECS``; returns the main path's launch counts, the launches
    its steps counted a slice (each kernel's launches over the steps,
    divided by their slices), the runtime (at splice 2) and its mean step
    time at splice 2 in seconds."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.elastic import ElasticRuntime
    from repro_torch.optim.adamw import global_norm
    from repro_torch.training.state import init_train_state
    from repro_torch.training.step import loss_and_grads

    spec = TRAIN_SPECS[path]
    print(f"\n== phase {spec['phase']}: {path}: {spec['arch']} training at "
          f"full width through ElasticRuntime", flush=True)
    full = get_config(spec["arch"])
    cfg = dataclasses.replace(full, num_layers=spec.get("layers")
                              or full.num_layers)
    n_params = cfg.param_count()
    donate = spec.get("donate", False)
    if cfg != full:
        per_param = 16 if donate else 28
        print(f"reduced: {full.num_layers} -> {cfg.num_layers} layers, "
              f"{full.param_count()} -> {n_params} parameters ({per_param} "
              f"bytes a parameter at the update: {per_param * n_params} "
              f"bytes); widths, experts, top-k, vocabulary and group "
              f"layout kept", flush=True)
    # 6 N T counts the parameters each token touches (MoE: its top-k
    # experts)
    n_active = cfg.active_param_count()
    steps = len(TRAIN["physical"])
    tcfg = TrainConfig(total_steps=steps, warmup_steps=2, learning_rate=1e-3)
    world, gb, seq = TRAIN["world"], TRAIN["batch"], TRAIN["seq"]
    tokens_per_step = gb * seq

    # splice invariance from one state at full width with 4 layers (or the
    # path's ``check_layers``), before the job's state takes the card: two
    # steps at splice 1 against two at splice 2 (test_elastic.py's bound).
    # MoE where nothing drops, without the aux loss and in the path's
    # ``check_dtype``: a slice routes its own tokens, its aux loss is a
    # statistic of its own tokens (E sum_e f_e p_e over half the batch is
    # not that over the whole), and bf16 router logits from GEMMs of
    # another row count may round differently and flip a near tie
    cfg4 = _no_drops(dataclasses.replace(
        cfg, num_layers=spec.get("check_layers", 4),
        dtype=spec.get("check_dtype", cfg.dtype)))
    if cfg4.moe is not None:
        cfg4 = dataclasses.replace(cfg4, moe=dataclasses.replace(
            cfg4.moe, router_aux_weight=0.0))

    def check_state():
        st = init_train_state(cfg4, tcfg, device="cuda")
        if spec.get("gates"):
            _set_gates(torch, st["params"])
        return st

    # a donated check updates its state in place: each splice factor then
    # starts from its own state, made from the same seed
    check_donate = spec.get("check_donate", False)
    state = None if check_donate else check_state()
    losses = {}
    for physical in (4, 2):
        rt4 = ElasticRuntime(cfg4, tcfg, world, physical, gb, seq,
                             state=check_state() if check_donate else state,
                             device="cuda", donate=check_donate)
        losses[rt4.splice] = [r["loss"] for r in rt4.run_steps(2)]
        del rt4
    rel = [abs(a - b) / abs(a) for a, b in zip(losses[1], losses[2])]
    print(f"splice invariance, {cfg.name} width with {cfg4.num_layers} "
          f"layers, {cfg4.dtype}{', donated' if check_donate else ''}, two "
          f"steps from one state: splice 1 "
          f"{losses[1]!r}, splice 2 {losses[2]!r}, rel diff {rel!r} (bound "
          f"1e-3)", flush=True)
    if not max(rel) < 1e-3:
        raise AssertionError("splice 1 and splice 2 disagree")
    del state
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    rt = ElasticRuntime(cfg, tcfg, world, TRAIN["physical"][0], gb, seq,
                        device="cuda", donate=donate)
    if spec.get("gates"):
        _set_gates(torch, rt.state["params"])
        print(f"cross gates set to {rt.state['params']['cross']['gate']}"
              f"; extra inputs "
              f"{[(k, tuple(v.shape)) for k, v in rt.extra_inputs.items()]}",
              flush=True)
    torch.cuda.synchronize()
    print(f"{cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, vocab "
          f"{cfg.vocab_size}, compute {cfg.dtype}, f32 master weights and "
          f"AdamW: {n_params} parameters ({n_active} per token); world "
          f"{world}, global batch {gb} x "
          f"{seq}; state made in {time.perf_counter() - t0:.2f} s", flush=True)
    STATE_BYTES[path] = torch.cuda.memory_allocated()
    print(f"state on the card after setup (torch.cuda.memory_allocated): "
          f"{STATE_BYTES[path]} bytes; the step "
          f"{'updates it in place (donate)' if donate else 'is functional'}",
          flush=True)

    # the kernel path against the plain path on the first batch (these
    # launches are comparisons: the counts are reset before the main path)
    loss_k, norm_k, leaf_norms = _first_batch_grads(torch, rt, loss_and_grads,
                                                    global_norm)
    before = {name: fn.launches for name, fn in counters.items()}
    with plain_versions():
        loss_p, norm_p, _ = _first_batch_grads(torch, rt, loss_and_grads,
                                               global_norm)
    if {name: fn.launches for name, fn in counters.items()} != before:
        raise AssertionError("the plain path launched a kernel")
    rel_loss = abs(loss_k - loss_p) / abs(loss_p)
    rel_norm = abs(norm_k - norm_p) / abs(norm_p)
    tol = spec["tol"]
    print(f"first batch, kernel path against plain path (plain versions on "
          f"the card): loss {loss_k!r} vs {loss_p!r} (rel {rel_loss!r}, bound "
          f"{tol['loss']}), grad_norm {norm_k!r} vs {norm_p!r} (rel "
          f"{rel_norm!r}, bound {tol['grad_norm']})", flush=True)
    if not rel_loss <= tol["loss"] or not rel_norm <= tol["grad_norm"]:
        raise AssertionError("the kernel path and the plain path disagree")
    zero = [key for key, n in leaf_norms.items()
            if not (math.isfinite(n) and n > 0)]
    print("gradient norm per leaf (kernel path): " + ", ".join(
        f"{key} {n:.4g}" for key, n in leaf_norms.items()), flush=True)
    if zero or len(leaf_norms) != spec["leaves"] or \
            not set(spec["named"]) <= set(leaf_norms):
        raise AssertionError(f"leaves without a finite nonzero gradient: "
                             f"{zero} of {sorted(leaf_norms)}")

    # the main path: counts to 0 just before, read just after
    for fn in counters.values():
        fn.launches = 0
    copies = _copies(counters)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    records = []
    in_steps = dict.fromkeys(counters, 0)
    for physical in TRAIN["physical"]:
        if physical != rt.physical:
            print(f"[resize] {rt.resize(physical)}", flush=True)
        before = {name: fn.launches for name, fn in counters.items()}
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        start.record()
        rec = rt.run_steps(1)[0]
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        peak = torch.cuda.max_memory_allocated()
        launched = {name: fn.launches - before[name]
                    for name, fn in counters.items()}
        s = rec["splice"]
        want = {name: spec["per_slice"].get(name, 0) * s
                for name in counters}
        share = 6 * n_active * tokens_per_step / (ms / 1e3) / \
            _peak_flops(torch, torch.bfloat16)
        print(f"[{card}] step {rec['step']} splice {s}: {ms!r} ms, "
              f"{tokens_per_step * 1e3 / ms!r} tokens/s, loss "
              f"{rec['loss']!r}, grad_norm {rec['grad_norm']!r}, peak memory "
              f"{peak} bytes, 6 N_active T / time = {share!r} of the bf16 "
              f"dense peak; launches {launched}", flush=True)
        if launched != want:
            raise AssertionError(f"expected launches {want} in a step at "
                                 f"splice {s}, saw {launched}")
        for name, n in launched.items():
            in_steps[name] += n
        if not (math.isfinite(rec["loss"]) and math.isfinite(rec["grad_norm"])):
            raise AssertionError(f"non-finite metrics {rec}")
        records.append(dict(rec, ms=ms))
        peaks = PEAK_BYTES.setdefault(path, {})
        peaks[s] = max(peaks.get(s, 0), peak)
    launches = {name: fn.launches for name, fn in counters.items()}
    slices = sum(r["splice"] for r in records)
    per_slice = {name: n // slices if n % slices == 0 else n / slices
                 for name, n in in_steps.items() if n}
    want_copies = {name: n + spec.get("copies_per_slice", {}).get(name, 0)
                   * slices for name, n in copies.items()}
    print(f"launches over the {steps} steps: {launches}; operands copied "
          f"for TMA: {_copies(counters)} (before: {copies}; expected "
          f"{want_copies}, {slices} slices)", flush=True)
    if _copies(counters) != want_copies:
        raise AssertionError("the kernels' wrappers copied operands on the "
                             "training path other than expected")

    # ln V + sigma^2 / 2, sigma^2 = d * 0.02^2 (dense_init scale 0.02)
    expect = math.log(cfg.vocab_size) + cfg.d_model * 0.02 ** 2 / 2
    first = records[0]["loss"]
    lo, hi = spec["first_loss"]
    print(f"first loss {first!r}; ln V + sigma^2/2 = {expect!r}; bounds "
          f"[{lo}, {hi}]", flush=True)
    if not lo <= first <= hi:
        raise AssertionError(f"first loss {first} outside [{lo}, {hi}]")

    _profile(torch, f"training step at splice {rt.splice} ({cfg.name}, "
             f"{tokens_per_step} tokens)", lambda: rt.run_steps(1), top=12)
    step_s = np.mean([r["ms"] for r in records if r["splice"] == 2]) / 1e3
    if donate:
        _update_transient(torch, rt)
    torch.cuda.empty_cache()

    return launches, per_slice, rt, float(step_s)


def _update_transient(torch, rt):
    """One donated AdamW update of the runtime's state with gradients of
    1e-3 N(0, 1): its peak memory above what was allocated before it must
    stay under two of the largest slices the update cuts (f32): it works
    on axis-0 slices of each leaf of at most ``UPDATE_CHUNK`` elements or
    one row (``optim/adamw.py::_row_slices``), so its transient is one
    slice.  (granite's largest slice is one layer of its largest leaf, an
    expert stack; llama-vision's one layer of an MLP stack, not a slice of
    its largest leaf, the embedding, which is cut into 16M-element
    slices.)"""
    from repro_torch.optim.adamw import _row_slices, adamw_update_
    from repro_torch.optim.schedule import lr_schedule
    from repro_torch.utils.tree import tree_leaves, tree_map

    params = rt.state["params"]
    grads = tree_map(lambda p: torch.randn_like(p).mul_(1e-3), params)
    shape, size = max(((tuple(t[rows].shape), t[rows].numel())
                       for t in tree_leaves(params)
                       for rows in _row_slices(t)), key=lambda x: x[1])
    bound = 2 * size * 4
    lr = lr_schedule(rt.state["step"], rt.tcfg)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    adamw_update_(params, grads, rt.state["opt"], lr, rt.tcfg)
    torch.cuda.synchronize()
    transient = torch.cuda.max_memory_allocated() - before
    print(f"donated update: transient memory {transient} bytes above "
          f"{before}; bound 2 x the largest slice the update cuts, "
          f"{shape} = {bound} bytes", flush=True)
    del grads
    if not transient < bound:
        raise AssertionError("the donated update's transient memory is "
                             "above two of its slices")


def phase_donate(torch):
    """The donated step against the functional one on the card: three steps
    of the olmo-1b smoke config from copies of one state, the donated
    runtime updating its state in place; losses, params, m and v equal to
    the bit."""
    from repro_torch.bridge import train_state_to_numpy
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.elastic import ElasticRuntime
    from repro_torch.training.state import init_train_state
    from repro_torch.utils.tree import tree_leaves, tree_map

    print("\n== phase donate: the donated step against the functional one, "
          "olmo-1b smoke config on the card", flush=True)
    cfg = get_smoke_config("olmo-1b")
    tcfg = TrainConfig(total_steps=3, warmup_steps=2, learning_rate=1e-3)
    state = init_train_state(cfg, tcfg, device="cuda")
    out = {}
    for donate in (False, True):
        rt = ElasticRuntime(cfg, tcfg, 4, 4, 8, 128,
                            state=tree_map(torch.clone, state),
                            device="cuda", donate=donate)
        losses = [r["loss"] for r in rt.run_steps(3)]
        out[donate] = (losses, tree_leaves(train_state_to_numpy(rt.state)))
    (loss_f, leaves_f), (loss_d, leaves_d) = out[False], out[True]
    same = sum(np.array_equal(a, b) for a, b in zip(leaves_f, leaves_d))
    print(f"losses functional {loss_f!r}, donated {loss_d!r}; {same} of "
          f"{len(leaves_f)} leaves of params, m, v, count and step equal to "
          f"the bit", flush=True)
    if loss_f != loss_d or same != len(leaves_f):
        raise AssertionError("the donated step differs from the functional "
                             "one")


def phase_train_f32(path=TRAIN_PATH):
    """One step of the path's smoke config at f32 from one state on the
    card and on the CPU: loss at 1e-5; m and v at 1e-5 of each leaf's
    largest entry.  Params: AdamW's first step moves an entry by
    lr (g / (|g| + eps) + wd p), which rests on g's last bits where |g| is
    near eps.  So only the firm entries (the path's ``f32_firm`` rule) are
    held to 1e-3 lr.  For olmo they are those with |g| >= 1e-6 (100 eps: a
    change dg moves the entry by at most 1e4 lr dg).  For mamba2, whose
    f32 leaves A_log and dt_bias have every |g| near 1e-6 at the smoke
    size, they are those where the two sides' gradients agree to 1e-3
    relative (a relative change r of g moves the entry by at most lr r / 4,
    whatever |g|).  The other, loose entries must be under 5% of each leaf
    and agree to 0.2 lr: an update flipped in sign is caught wherever it
    moves an entry by more than 0.1 lr."""
    import torch

    from repro_torch.bridge import train_state_from_jax, train_state_to_numpy
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import DataPipeline
    from repro_torch.models.frontend import synth_extra_inputs
    from repro_torch.training import build_train_step, init_train_state

    spec = TRAIN_SPECS[path]
    arch, rule = spec["arch"], spec["f32_firm"]
    print(f"\n== phase {spec['phase']}b: f32 training step of the {arch} "
          f"smoke config, card against CPU", flush=True)
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    tcfg = TrainConfig(total_steps=40, warmup_steps=2, learning_rate=1e-3)
    cpu_state = init_train_state(cfg, tcfg, device="cpu")
    _set_gates(torch, cpu_state["params"])
    card_state = train_state_from_jax(train_state_to_numpy(cpu_state), cfg,
                                      device="cuda")
    tokens, labels = DataPipeline(cfg.vocab_size, 128, 4, 4).next_batch()
    extra = synth_extra_inputs(cfg, 4, 1)
    step = build_train_step(cfg, tcfg, splice=2)
    out = {}
    for device, state in (("cpu", cpu_state), ("cuda", card_state)):
        batch = {"tokens": torch.as_tensor(tokens, device=device).long(),
                 "labels": torch.as_tensor(labels, device=device).long(),
                 **{k: v.to(device) for k, v in extra.items()}}
        new, metrics = step(state, batch)
        out[device] = (train_state_to_numpy(new), metrics["loss"].item(),
                       metrics["lr"].item())
    (cpu_new, cpu_loss, lr), (card_new, card_loss, _) = out["cpu"], out["cuda"]
    np.testing.assert_allclose(card_loss, cpu_loss, rtol=1e-5)

    def leaves(t):
        if isinstance(t, dict):
            return [x for val in t.values() for x in leaves(val)]
        return [] if t is None else [t]

    worst = {}
    for part in ("m", "v"):
        for a, b in zip(leaves(card_new["opt"][part]),
                        leaves(cpu_new["opt"][part])):
            scale = np.abs(b).max()
            np.testing.assert_allclose(a / scale, b / scale, rtol=0,
                                       atol=1e-5)
            worst[part] = max(worst.get(part, 0.0),
                              float(np.abs(a - b).max() / scale))
    firm_diff, loose_diff, shares = 0.0, 0.0, []
    for a, b, m, m_card in zip(leaves(card_new["params"]),
                               leaves(cpu_new["params"]),
                               leaves(cpu_new["opt"]["m"]),
                               leaves(card_new["opt"]["m"])):
        firm = F32_FIRM[rule](tcfg.beta1, m, m_card)
        shares.append(float(1 - firm.mean()))
        if not shares[-1] < 0.05:
            raise AssertionError(f"{shares[-1]} of a leaf is not firm "
                                 f"({rule})")
        np.testing.assert_allclose(a[firm], b[firm], rtol=0, atol=1e-3 * lr)
        np.testing.assert_allclose(a[~firm], b[~firm], rtol=0, atol=0.2 * lr)
        diff = np.abs(a - b)
        firm_diff = max(firm_diff, float(diff[firm].max()))
        if not firm.all():
            loose_diff = max(loose_diff, float(diff[~firm].max()))
    print(f"{arch} smoke config, f32, splice 2, batch 4 x 128: loss card "
          f"{card_loss!r} vs CPU {cpu_loss!r}; m and v within {worst!r} of "
          f"each leaf's largest entry (1e-5); params max |diff| "
          f"{firm_diff!r} where {rule} (bound 1e-3 lr = "
          f"{1e-3 * lr!r}), {loose_diff!r} = {loose_diff / lr!r} lr "
          f"elsewhere (bound 0.2 lr); share of the rest per leaf "
          f"{[f'{x:.4g}' for x in shares]} (bound 0.05)", flush=True)


DRYRUN_PATH = "dryrun"
# the planner's pairs: (arch, shape, mesh, extra CLI arguments); each runs
# as its own ``python -m repro_torch.launch.dryrun`` process (a fake world
# of 256 or 512 ranks is a process's own), all at once, on the host
DRYRUN_PAIRS = [
    ("olmo-1b", "train_4k", "single", []),
    ("granite-moe-3b-a800m", "train_4k", "single", []),
    ("zamba2-1.2b", "prefill_32k", "single", []),
    ("yi-9b", "decode_32k", "single", ["--donate"]),
    ("llama-3.2-vision-11b", "train_4k", "multi", []),
]
# one device, donated: its state bytes and swa_flash ops against phase 9's
GRANITE_ONE = ("granite-moe-3b-a800m", "train_4k", "single",
               ["--mesh-shape", "1,1", "--donate"])
# the vlm-train path's configuration (its depth, batch and donation) on one
# device: the planner's bytes per device beside the card's peak at splice 1
VLM_ONE = ("llama-3.2-vision-11b", "train_4k", "single",
           ["--mesh-shape", "1,1", "--donate", "--layers",
            str(TRAIN_SPECS[VLM_TRAIN_PATH]["layers"]), "--global-batch",
            str(TRAIN["batch"])])
DRYRUN_PAIRS += [GRANITE_ONE, VLM_ONE]
DRYRUN_TIMEOUT = 600
# the (1, 1) pair's batch: tokens and labels, 256 x 4096 int64
DRYRUN_BATCH_BYTES = 2 * 256 * 4096 * 8


def phase_dryrun(state_bytes, swa_per_slice, vlm_peak):
    """The dry-run planner on the host (no card): each pair of
    ``DRYRUN_PAIRS`` traced on fake tensors in a fake world of the mesh's
    size, the kernels' ops running their fake implementations; its
    roofline terms (data-sheet models), bytes per device, kernel ops and
    trace seconds.  The one-device donated granite pair's state (its
    arguments less the batch) and its aliased bytes must be within 1% of
    ``state_bytes``, phase 9's ``torch.cuda.memory_allocated()`` after its
    setup, and its ``swa_flash`` ops per slice equal ``swa_per_slice``,
    the launches phase 9 counted per slice on the card.  The vlm-train
    configuration's bytes per device are printed beside ``vlm_peak``, the
    card's peak at splice 1 (phase 12).  Returns the records."""
    import os

    print(f"\n== phase {DRYRUN_PATH}: the planner's pairs, traced on the "
          f"host", flush=True)
    out_dir = ROOT / "build" / "dryrun"
    out_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="")
    jobs = []
    t0 = time.perf_counter()
    for i, (arch, shape, mesh, extra) in enumerate(DRYRUN_PAIRS):
        out = out_dir / f"{i}.{arch}.{shape}.{mesh}.json"
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--mesh", mesh, "--out", str(out),
               *extra]
        jobs.append((arch, shape, mesh, extra, out, subprocess.Popen(
            cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))
    records = []
    try:
        for arch, shape, mesh, extra, out, proc in jobs:
            _, err = proc.communicate(timeout=DRYRUN_TIMEOUT)
            if proc.returncode != 0:
                lines = [ln for ln in err.splitlines() if ln.strip()
                         and "Warn" not in ln and "alltoall" not in ln]
                raise AssertionError(f"dry-run {arch} x {shape} [{mesh}] "
                                     f"{extra} failed:\n"
                                     + "\n".join(lines[-60:]))
            rec = json.loads(out.read_text())
            if rec.get("status") != "ok":
                raise AssertionError(f"dry-run {arch} x {shape}: {rec}")
            rf, mem = rec["roofline"], rec["memory"]
            print(f"{arch} x {shape} [{mesh}{' ' + ' '.join(extra) if extra else ''}]"
                  f" chips {rec['chips']}: compute_s {rf['compute_s']!r}, "
                  f"memory_s {rf['memory_s']!r}, collective_s "
                  f"{rf['collective_s']!r}, dominant {rf['dominant']}, "
                  f"useful_flop_ratio {rf['useful_flop_ratio']!r}, "
                  f"bytes_per_device {mem['bytes_per_device']}, "
                  f"trace_seconds {rec['trace_seconds']}; kernel ops "
                  f"{rec['kernel_ops']}; op_cost {rec['op_cost']}; memory "
                  f"{mem}; collectives {rec['collectives']}", flush=True)
            records.append(rec)
    finally:
        for *_, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    print(f"dry-run phase: {len(records)} pairs in "
          f"{time.perf_counter() - t0:.1f} s (in parallel); the terms are "
          f"data-sheet models (H100 SXM bf16 peak, HBM and InfiniBand NDR "
          f"rates), not measurements", flush=True)
    granite = records[DRYRUN_PAIRS.index(GRANITE_ONE)]
    mem = granite["memory"]
    state = mem["argument_size_in_bytes"] - DRYRUN_BATCH_BYTES
    for name, val in (("arguments less the batch", state),
                      ("aliased", mem["alias_size_in_bytes"])):
        rel = abs(val - state_bytes) / state_bytes
        print(f"granite-moe one-device dry-run, donated: {name} {val} bytes "
              f"against the card's state after phase 9's setup "
              f"{state_bytes} bytes: rel {rel!r} (bound 0.01)", flush=True)
        if not rel <= 0.01:
            raise AssertionError("the dry-run's state bytes disagree with "
                                 "the card's")
    traced = granite["kernel_ops"].get("swa_flash", 0) / granite["splice"]
    print(f"granite-moe one-device dry-run: {traced!r} swa_flash ops a "
          f"slice; phase 9 launched {swa_per_slice} a slice on the card",
          flush=True)
    if traced != swa_per_slice:
        raise AssertionError("the dry-run traces other swa_flash calls than "
                             "the card launches")
    planned = records[DRYRUN_PAIRS.index(VLM_ONE)]["memory"][
        "bytes_per_device"]
    print(f"vlm-train's configuration on one device: the planner's "
          f"bytes_per_device {planned} against the card's peak at splice 1 "
          f"{vlm_peak} (ratio {planned / vlm_peak!r}; a model of eager live "
          f"bytes, not a bound)", flush=True)
    return records


def _host_memory() -> dict:
    """MemTotal and MemAvailable of the host (/proc/meminfo), in bytes."""
    out = {}
    for line in Path("/proc/meminfo").read_text().splitlines():
        key, val = line.split(":")
        if key in ("MemTotal", "MemAvailable"):
            out[key] = int(val.split()[0]) * 1024
    return out


def _peak_rss() -> int:
    """This process's peak resident memory so far, in bytes."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def _digests(torch, fingerprint, tree_flatten, state):
    """Each leaf's 128-bit digest, computed on the card in the manifest's
    (JAX's) leaf order; only the digests come to the host.  Returns the
    digests and their device time in ms."""
    leaves, paths = tree_flatten(state)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    ds = torch.stack([fingerprint(leaf) for leaf in leaves])
    end.record()
    torch.cuda.synchronize()
    digests = {"/".join(p): "".join(f"{v:08x}" for v in d)
               for p, d in zip(paths, ds.cpu().tolist())}
    return digests, start.elapsed_time(end)


def _host_rates(torch, leaf):
    """Seconds per GB of each host step of the dump and the restore, on one
    leaf of the state (``leaf``, on the card), as the store does them:
    card to host, ``np.save`` into memory, 1 MiB slices, blake2b of each,
    then the join, ``np.load`` and the host copy and card upload of
    ``ElasticRuntime.from_snapshot``."""
    import io

    from repro_torch.core.checkpoint import CHUNK
    from repro_torch.utils.hashing import chunk_checksums

    secs = {}
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        t1 = time.perf_counter()
        secs[name] = t1 - t0
        t0 = t1

    arr = leaf.cpu().numpy()
    lap("card to host")
    buf = io.BytesIO()
    np.save(buf, arr, allow_pickle=False)
    data = buf.getvalue()
    del buf
    lap("np.save")
    pieces = [data[i:i + CHUNK] for i in range(0, len(data), CHUNK)]
    lap("1 MiB slices")
    for piece in pieces:
        chunk_checksums(piece, len(piece))
    lap("blake2b")
    joined = b"".join(pieces)
    lap("join")
    back = np.load(io.BytesIO(joined), allow_pickle=False)
    lap("np.load")
    torch.from_numpy(back.copy()).to("cuda")
    torch.cuda.synchronize()
    lap("host copy and card upload")
    return {k: v / arr.nbytes * 1e9 for k, v in secs.items()}


def phase_migrate(torch, card, counters, job, step_s):
    """Phase 4's job (``job``, a list holding the only reference to its
    runtime) through preemption, checkpoint and migration; returns the
    path's launch counts."""
    from repro_torch.core import CheckpointStore, migrate
    from repro_torch.kernels.checksum import fingerprint
    from repro_torch.utils import constants
    from repro_torch.utils.tree import tree_flatten

    print(f"\n== phase 5: {MIGRATE_PATH}: preempt, dump, move and resume "
          f"phase 4's olmo-1b job", flush=True)
    rt = job.pop()
    world, gb, seq = TRAIN["world"], TRAIN["batch"], TRAIN["seq"]
    cfg, tcfg = rt.cfg, rt.tcfg
    state_bytes = sum(t.numel() * t.element_size()
                      for t in tree_flatten(rt.state)[0])
    print(f"job at step {int(rt.state['step'])}, splice {rt.splice}, world "
          f"{world}; state {state_bytes} bytes in "
          f"{len(tree_flatten(rt.state)[0])} leaves; host {_host_memory()}, "
          f"peak RSS so far {_peak_rss()} bytes", flush=True)

    # the main path: counts to 0 just before, read just after
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    rt.request_preemption()
    recs = rt.run_steps(4, stop_on_barrier=True)
    if not (len(recs) <= 2 and rt.quiesced):
        raise AssertionError(f"not quiesced within 2 steps: {recs}")
    splice_quiesce = rt.splice
    print(f"quiesced after {len(recs)} steps at splice {rt.splice} (barrier "
          f"acquired {[r['barrier_acquired'] for r in recs]}), step "
          f"{int(rt.state['step'])}", flush=True)

    before, fp_ms = _digests(torch, fingerprint, tree_flatten, rt.state)
    print(f"digested the {len(before)} leaves on the card in {fp_ms!r} ms "
          f"(device time of the {len(before)} launches)", flush=True)

    store = CheckpointStore()
    rss0 = _peak_rss()
    t0 = time.perf_counter()
    new_rt, report = migrate(rt, store, MIGRATE_PATH, 4, cfg, tcfg, gb, seq,
                             per_step_seconds=step_s, device="cuda")
    wall = time.perf_counter() - t0
    manifest = store.manifests[MIGRATE_PATH][-1]
    logical = sum(len(store.chunks[c])
                  for entry in manifest["workers"].values()
                  for refs in entry["device"] for c in refs)
    print(f"[{card}] MigrationReport: barrier {report.barrier_seconds!r} s "
          f"({report.barrier_minibatches} mini-batches x {step_s!r} s, the "
          f"protocol engine's count), dump {report.dump_seconds!r} s, upload "
          f"{report.upload_seconds!r} s and download "
          f"{report.download_seconds!r} s (modelled: "
          f"{report.device_stored_bytes + report.host_stored_bytes} bytes at "
          f"the paper's {constants.BLOB_STORE_BANDWIDTH!r} B/s), restore "
          f"{report.restore_seconds!r} s, total {report.total_seconds!r} s; stored device bytes "
          f"{report.device_stored_bytes} of {logical} logical over "
          f"{world} workers, host bytes {report.host_stored_bytes}, store "
          f"{store.stored_bytes()} bytes; migrate() wall {wall!r} s; peak "
          f"RSS {_peak_rss()} bytes (was {rss0})", flush=True)
    if not report.work_conserving:
        raise AssertionError("the migration lost work")
    if not report.device_stored_bytes <= logical / world:
        raise AssertionError(f"stored {report.device_stored_bytes} > logical "
                             f"{logical} / {world}")
    if new_rt.splice != 1 or int(new_rt.state["step"]) != \
            int(rt.state["step"]):
        raise AssertionError("the destination is not at the source's step")

    after, fp_ms_2 = _digests(torch, fingerprint, tree_flatten, new_rt.state)
    differ = [k for k in before if before[k] != after.get(k)]
    print(f"destination's {len(after)} digests in {fp_ms_2!r} ms; equal to "
          f"the source's: {not differ and len(after) == len(before)}; "
          f"embed {after['params/embed']}, step {after['step']}", flush=True)
    if differ or len(after) != len(before):
        raise AssertionError(f"leaves changed by the migration: {differ}")

    # where the dump's and the restore's time goes: each host step's rate
    # on the largest leaf, and the sums those rates give for the whole
    # state (4 workers hashed and 4 trees restored, as the store does)
    del store, manifest
    rates = _host_rates(torch,
                        new_rt.state["opt"]["m"]["blocks"]["mlp"]["wg"])
    state_gb = state_bytes / 1e9
    dump_model = state_gb * (rates["card to host"] + world * (
        rates["np.save"] + rates["1 MiB slices"] + rates["blake2b"]))
    restore_model = state_gb * (world * (rates["join"] + rates["np.load"])
                                + rates["host copy and card upload"])
    print(f"host steps on the 1 GiB leaf, s per GB: "
          f"{ {k: round(v, 4) for k, v in rates.items()} }; for the state "
          f"they give dump {dump_model!r} s (measured "
          f"{report.dump_seconds!r}), restore {restore_model!r} s "
          f"(measured {report.restore_seconds!r})", flush=True)

    # one step on each runtime at the same splice, from the same state and
    # the same data cursor; the source's buffers are freed before the
    # destination's step.  The states after the step are digested too, to
    # show whether the whole step (backward and AdamW included) is
    # deterministic on the card; those 52 digests are a check, not the
    # path, and are taken out of its count.
    rt.barrier.reset()
    rt.resize(new_rt.physical)
    loss_src = rt.run_steps(1)[0]["loss"]
    checks = counters["fingerprint_u32"].launches
    src_next, _ = _digests(torch, fingerprint, tree_flatten, rt.state)
    checks = counters["fingerprint_u32"].launches - checks
    del rt
    torch.cuda.empty_cache()
    loss_dst = new_rt.run_steps(1)[0]["loss"]
    launches = {name: fn.launches for name, fn in counters.items()}
    launches["fingerprint_u32"] -= checks
    dst_next, _ = _digests(torch, fingerprint, tree_flatten, new_rt.state)
    rel = abs(loss_src - loss_dst) / abs(loss_src)
    print(f"one step at splice {new_rt.splice} on each: source loss "
          f"{loss_src!r}, destination {loss_dst!r}, rel diff {rel!r} (bound "
          f"1e-6); equal to the bit: {loss_src == loss_dst}", flush=True)
    differ = [k for k in src_next if src_next[k] != dst_next[k]]
    print(f"the states after that step: "
          f"{len(src_next) - len(differ)} of {len(src_next)} leaves equal "
          f"to the bit; differing (run-to-run order of the card's sums): "
          f"{differ}", flush=True)
    if not rel <= 1e-6:
        raise AssertionError("the resumed job's loss differs")
    want = {"swa_flash": 2 * cfg.num_layers * (splice_quiesce * len(recs) + 2),
            "swa_flash_bwd": cfg.num_layers * (splice_quiesce * len(recs) + 2),
            "ssd_intra_chunk": 0,
            "fused_ce_stats": splice_quiesce * len(recs) + 2,
            "fingerprint_u32": 2 * len(before)}
    print(f"launches on {MIGRATE_PATH}: {launches}; peak device memory "
          f"{torch.cuda.max_memory_allocated()} bytes", flush=True)
    if launches != want:
        raise AssertionError(f"expected launches {want}, saw {launches}")
    del new_rt
    torch.cuda.empty_cache()
    return launches


FLEET_PATH = "fleet-executor"

def phase_fleet(torch, counters):
    """The three scenarios of tests/test_executor.py through the port's
    ``FleetExecutor`` on the card (the path ``fleet-executor``: counts to 0
    just before, read just after) and on the CPU; each log must equal the
    CPU's, event for event.  Returns the path's launch counts."""
    from repro_torch.scheduler.executor import FleetExecutor, ManagedJob
    from repro_torch.scheduler.job_table import TableJob
    from repro_torch.scheduler.scenarios import SCENARIOS

    print(f"\n== phase 7: {FLEET_PATH}: the executor's scenarios on the card "
          f"and on the CPU", flush=True)
    classes = (FleetExecutor, ManagedJob, TableJob)
    cpu_logs, secs = [], {}
    t0 = time.perf_counter()
    for scenario in SCENARIOS:
        cpu_logs.append(scenario(*classes, "cpu"))
    secs["cpu"] = time.perf_counter() - t0

    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    card_logs = [scenario(*classes, "cuda") for scenario in SCENARIOS]
    torch.cuda.synchronize()
    secs["cuda"] = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}

    for scenario, card_log, cpu_log in zip(SCENARIOS, card_logs, cpu_logs):
        print(f"{scenario.__name__}: card log {card_log}", flush=True)
        if card_log != cpu_log:
            raise AssertionError(f"the card's log differs from the CPU's: "
                                 f"{card_log} vs {cpu_log}")
    print(f"the three logs equal the CPU's, event for event; wall "
          f"{secs['cuda']!r} s on the card, {secs['cpu']!r} s on the CPU; "
          f"launches on {FLEET_PATH}: {launches}", flush=True)
    missing = [name for name in ("swa_flash", "ssd_intra_chunk",
                                 "fused_ce_stats") if not launches[name]]
    if missing or launches["fingerprint_u32"]:
        raise AssertionError(f"expected the olmo and mamba2 jobs' kernels "
                             f"and no fingerprint_u32, saw {launches}")
    torch.cuda.empty_cache()
    return launches


SIM_PATH = "fleet-sim"


def phase_fleet_sim(counters):
    """One seeded trace through the port's ``FleetSimulator`` (failures,
    snapshots, the serving tier with loaning, concave curves; the trace of
    ``tests/test_torch_simulator.py``, whose digest there equals the JAX
    simulator's).  The simulator is numpy: the path launches no kernel (the
    counts are set to 0 before and read after).  It shows the simulator
    runs on the card's machine, which has no JAX.  Returns the counts."""
    import importlib

    from repro_torch.scheduler.scenarios import seeded_fleet_trace

    print(f"\n== phase 11: {SIM_PATH}: a seeded fleet trace through the "
          f"port's FleetSimulator", flush=True)
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    digest, res, decisions = seeded_fleet_trace(
        lambda m: importlib.import_module(f"repro_torch.{m}"))
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    again, _, _ = seeded_fleet_trace(
        lambda m: importlib.import_module(f"repro_torch.{m}"))
    print(f"decision digest {digest} over {decisions} decisions (again: "
          f"{again}); wall {wall!r} s on the host; utilization "
          f"{res.utilization!r}, completed {res.completed} of "
          f"{res.total_jobs}, preemptions {res.preemptions}, migrations "
          f"{res.migrations}, resizes {res.resizes}, job failures "
          f"{res.job_failures}, snapshots {res.snapshots}, goodput "
          f"{res.goodput_fraction!r}; serving: SLO attainment "
          f"{res.serving_slo_attainment!r} over {res.serving_windows} "
          f"windows, {res.serving_reclaims} reclaims (max "
          f"{res.serving_reclaim_max_seconds!r} s, deadline "
          f"{res.serving_reclaim_deadline_seconds!r} s), loaned "
          f"{res.serving_loaned_gpu_hours!r} GPU-hours; launches {launches}",
          flush=True)
    if again != digest or any(launches.values()):
        raise AssertionError("the trace is not deterministic, or launched "
                             "a kernel")
    if not (decisions > 100 and res.job_failures > 0
            and res.serving_reclaims > 0 and res.serving_loaned_gpu_hours > 0
            and res.serving_reclaims_over_deadline == 0):
        raise AssertionError(f"the trace did not exercise failures and the "
                             f"serving tier: {res}")
    return launches


def _copies(counters) -> dict:
    """The copies each wrapper has made of an operand its kernel's TMA
    cannot read in place (``swa_flash``, ``fused_ce_stats``)."""
    return {name: fn.copies for name, fn in counters.items()
            if hasattr(fn, "copies")}


def _set_gates(torch, params, seed=0):
    """The audio and VLM cross gates set to uniform [0.3, 0.9) from a
    numpy seed (f32, in place): they are zero at init, where every cross
    block adds nothing, so a check at init would not see the encoder, the
    cross attention or the cross caches."""
    if "cross" in params:
        gate = params["cross"]["gate"]
        gate.copy_(torch.from_numpy(np.random.default_rng(seed).uniform(
            0.3, 0.9, gate.shape)))


def phase_serve(torch, card, arch, expected, counters, tools):
    """One serving path at full width; returns its launch counts."""
    get_config, ServingEngine, prefill_fn, decode_step_fn = tools
    from repro_torch.models.frontend import synth_extra_inputs

    n_batch, n_prompt = SERVE_SHAPES.get(arch, (BATCH, PROMPT))
    print(f"\n== phase 3: {arch} at full width through ServingEngine",
          flush=True)
    cfg = get_config(arch)
    t0 = time.perf_counter()
    engine = ServingEngine(cfg, seed=0, device="cuda")
    _set_gates(torch, engine.params)
    torch.cuda.synchronize()
    print(f"{cfg.name} [{cfg.arch_type}]: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab_size}, window "
          f"{cfg.sliding_window}, {cfg.dtype}: {cfg.param_count()} "
          f"parameters, made in {time.perf_counter() - t0:.2f} s", flush=True)
    checked = DECODE_CHECK_STEPS.get(arch, 1)
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (n_batch, n_prompt + checked))
    # the frame or patch embeddings generate() draws (its seed + 7)
    extra = synth_extra_inputs(cfg, n_batch, 7, device="cuda")
    if extra:
        print(f"extra inputs {[(k, tuple(v.shape)) for k, v in extra.items()]}"
              f"; cross gates {engine.params['cross']['gate'].tolist()}",
              flush=True)

    # the main path: counts to 0 just before, read just after
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    copies = _copies(counters)
    t0 = time.perf_counter()
    out = engine.generate(prompts[:, :n_prompt], max_new_tokens=NEW_TOKENS)
    out = out.cpu()
    first_wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    peak_bytes = torch.cuda.max_memory_allocated()
    print(f"generate(batch {n_batch}, prompt {n_prompt}, {NEW_TOKENS} new, "
          f"greedy): launches {launches}, first call {first_wall:.3f} s",
          flush=True)
    if launches != expected:
        raise AssertionError(f"expected launches {expected} in one prefill "
                             f"of {arch}, saw {launches}")
    if _copies(counters) != copies:
        raise AssertionError(f"the kernels' wrappers copied an operand on "
                             f"{arch}'s path: {copies} -> {_copies(counters)}")
    if out.shape != (n_batch, NEW_TOKENS):
        raise AssertionError(f"generated shape {tuple(out.shape)}")
    if not ((out >= 0) & (out < cfg.vocab_size)).all():
        raise AssertionError("generated token ids out of range")
    print("generated ids (first row):", out[0].tolist(), flush=True)

    with torch.inference_mode():
        tokens = torch.as_tensor(prompts, device="cuda")
        batch = {"tokens": tokens[:, :n_prompt], **extra}
        prefill_ms = time_ms(
            torch, lambda: prefill_fn(engine.params, batch, cfg,
                                      cache_len=n_prompt + NEW_TOKENS), 5, 1)
        logits, state = prefill_fn(engine.params, batch, cfg,
                                   cache_len=n_prompt + NEW_TOKENS)
        if logits.shape != (n_batch, cfg.vocab_size) or \
                logits.dtype != torch.float32:
            raise AssertionError(f"logits {tuple(logits.shape)} {logits.dtype}")
        if not torch.isfinite(logits).all():
            raise AssertionError("non-finite prefill logits")
        tok = logits.argmax(-1)
        steps = NEW_TOKENS - 1
        decode_ms = time_ms(
            torch, lambda: decode_step_fn(engine.params, state, tok, cfg),
            steps, 0)
        _profile(torch, f"{arch} prefill (batch {n_batch} x {n_prompt})",
                 lambda: prefill_fn(engine.params, batch, cfg,
                                    cache_len=n_prompt + NEW_TOKENS))
        _profile(torch, f"{arch} decode step (batch {n_batch})",
                 lambda: decode_step_fn(engine.params, state, tok, cfg))
    t0 = time.perf_counter()
    engine.generate(prompts[:, :n_prompt], max_new_tokens=NEW_TOKENS).cpu()
    warm_wall = time.perf_counter() - t0
    print(f"[{card}] {arch}: prefill {prefill_ms!r} ms (batch {n_batch} x "
          f"{n_prompt}); decode {decode_ms!r} ms/token step (batch "
          f"{n_batch}), {n_batch * 1e3 / decode_ms!r} tokens/s; generate "
          f"warm {warm_wall!r} s = {n_batch * NEW_TOKENS / warm_wall!r} new "
          f"tokens/s; peak device memory {peak_bytes} bytes", flush=True)

    # decode-vs-prefill at full width, bf16: prefill(s) + k decode steps
    # against prefill(s + k) (k 1, or ``DECODE_CHECK_STEPS``; MoE where
    # nothing drops, ``_no_drops``).  The
    # two paths round bf16 activations at other places through every
    # layer; that moved the largest of 4 x 50304 olmo-1b logits by 0.126 in
    # this script's first run (spread of the logits about 1).  A fault of structure (cache slot, mask, position,
    # carried SSM state) moves logits by their own spread.  So the bound is
    # a quarter of the logits' standard deviation; the tight check is the
    # f32 one in phase 3b.
    with torch.inference_mode():
        dec, ref = _decode_vs_prefill(torch, engine.params, _no_drops(cfg),
                                      tokens, prefill_fn, decode_step_fn,
                                      extra, checked)
    diff = (dec - ref).abs()
    err = diff.max().item()
    bound = DECODE_BF16_BOUND.get(arch, 0.25) * ref.std().item()
    print(f"{arch} decode vs prefill, bf16, batch {n_batch}, prompt "
          f"{n_prompt}, {checked} decode steps: "
          f"max |diff| {err!r}, mean |diff| {diff.mean().item()!r}, logits "
          f"std {ref.std().item()!r}, max |logit| "
          f"{ref.abs().max().item()!r}; bound {bound!r}", flush=True)
    if not math.isfinite(err) or err > bound:
        raise AssertionError(f"{arch} decode vs prefill at bf16 differs by "
                             f"{err}")
    del engine, state, logits
    torch.cuda.empty_cache()
    return launches


def _profile(torch, label, fn, top=8):
    """Where one warm call's time goes: wall time (host clock around the
    call and a synchronize), the device's busy time (the sum of its kernel
    times; kernels on one stream do not overlap) and the kernels that take
    most of it, from ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    if busy <= 0:
        raise AssertionError(f"the profiler saw no device time in {label}")
    print(f"profile of one {label}: wall {wall_ms!r} ms, device busy "
          f"{busy!r} ms ({busy / wall_ms:.3f} of wall), {sum(e.count for e in rows)}"
          f" kernels; top by device time:", flush=True)
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"  {e.self_device_time_total / 1e3:10.4f} ms  x{e.count:<5d} "
              f"{e.key[:100]}", flush=True)


def _no_drops(cfg):
    """``cfg``, for MoE at the capacity factor E_tot / k, whose capacity
    holds a call's every token at every expert, so nothing drops.  Which
    entries drop depends on the tokens of the call (a decode step routes B
    of them, a prefill B S, a slice of a spliced step B S / s), so only
    where nothing drops must decode agree with prefill, and splice 1 with
    splice 2 (tests/test_decode_consistency.py gives MoE a factor of 64
    for the same reason)."""
    if cfg.moe is None:
        return cfg
    from repro_torch.models.moe import EXPERT_PAD

    e_tot = -(-cfg.moe.num_experts // EXPERT_PAD) * EXPERT_PAD
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=e_tot / cfg.moe.top_k))


def _decode_vs_prefill(torch, params, cfg, tokens, prefill_fn,
                       decode_step_fn, extra=None, steps=None):
    """The last logits of ``steps`` decode steps (default 1) over the last
    tokens of ``tokens`` after a prefill of the others, against those of a
    prefill of them all."""
    extra = extra or {}
    steps = steps or 1
    s = tokens.shape[1] - steps
    _, state = prefill_fn(params, {"tokens": tokens[:, :s], **extra}, cfg,
                          cache_len=tokens.shape[1])
    for i in range(steps):
        dec, state = decode_step_fn(params, state, tokens[:, s + i], cfg)
    ref, _ = prefill_fn(params, {"tokens": tokens, **extra}, cfg)
    return dec, ref


def phase_checks(torch, get_config, get_smoke_config, init_params,
                 prefill_fn, decode_step_fn, ServingEngine):
    from repro_torch.bridge import params_from_jax, params_to_numpy

    print("\n== phase 3b: f32 checks", flush=True)
    # decode-vs-prefill at full width in f32 (tests/test_decode_consistency
    # bound, 2e-3; MoE where nothing drops); the SSM models on a prompt
    # of 256, two whole chunks, so that the decode step's prefill(257) has
    # a ragged third chunk
    # h2o-danube-3-4b from a prompt of 4,160, past its window of 4,096, for
    # 4 steps; whisper-base and llama-3.2-vision-11b (40.5 GB of f32
    # weights) with their gates set and frame or patch embeddings
    from repro_torch.models.frontend import synth_extra_inputs

    for arch, prompt, steps in (
            ("olmo-1b", 128, 1), ("mamba2-130m", 256, 1),
            ("zamba2-1.2b", 256, 1), ("granite-moe-3b-a800m", 128, 1),
            ("h2o-danube-3-4b", 4160, 4), ("whisper-base", 128, 1),
            ("llama-3.2-vision-11b", 128, 1)):
        cfg = _no_drops(dataclasses.replace(get_config(arch),
                                            dtype="float32"))
        params = init_params(cfg, 0, device="cuda")
        _set_gates(torch, params)
        tokens = torch.as_tensor(np.random.default_rng(2).integers(
            0, cfg.vocab_size, (2, prompt + steps)), device="cuda")
        extra = synth_extra_inputs(cfg, 2, 1, device="cuda")
        with torch.inference_mode():
            dec, ref = _decode_vs_prefill(torch, params, cfg, tokens,
                                          prefill_fn, decode_step_fn, extra,
                                          steps)
        torch.testing.assert_close(dec, ref, rtol=2e-3, atol=2e-3)
        print(f"{arch} decode vs prefill, f32, full width, batch 2, prompt "
              f"{prompt}, {steps} decode steps: max |diff| "
              f"{(dec - ref).abs().max().item()!r} within 2e-3", flush=True)
        del params, extra
        torch.cuda.empty_cache()

    # the card path (CUDA kernels) against the CPU path (plain versions) on
    # the smoke configs, same weights, f32: logits within 1e-4 and the same
    # greedy tokens
    for arch in ("olmo-1b", "mamba2-130m", "granite-moe-3b-a800m"):
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        cpu_params = init_params(cfg, 0, device="cpu")
        gpu_params = params_from_jax(params_to_numpy(cpu_params), cfg, "cuda")
        prompts = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 48))
        with torch.inference_mode():
            got, _ = prefill_fn(gpu_params, {"tokens": torch.as_tensor(
                prompts, device="cuda")}, cfg)
            want, _ = prefill_fn(cpu_params,
                                 {"tokens": torch.as_tensor(prompts)}, cfg)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
        gen_gpu = ServingEngine(cfg, params=gpu_params,
                                device="cuda").generate(
            prompts, max_new_tokens=8).cpu()
        gen_cpu = ServingEngine(cfg, params=cpu_params, device="cpu").generate(
            prompts, max_new_tokens=8)
        if not torch.equal(gen_gpu, gen_cpu):
            raise AssertionError(f"{arch}: greedy tokens differ: card "
                                 f"{gen_gpu.tolist()} cpu {gen_cpu.tolist()}")
        print(f"{arch} smoke config, f32: card vs CPU prefill logits max "
              f"|diff| {(got.cpu() - want).abs().max().item()!r} within 1e-4;"
              f" 8 greedy tokens equal", flush=True)

    # the sliding window, audio and VLM families on their smoke configs at
    # f32, gates set, the same weights and frame or patch embeddings on
    # both devices: on the card, decode against prefill (h2o-danube from a
    # prompt of 160, past its window of 128, for 40 steps that each write
    # a ring slot over the oldest position); card against CPU, the prefill
    # logits within 1e-4 and 8 greedy tokens equal
    from repro_torch.models.frontend import synth_extra_inputs

    for arch, prompt, steps in (("h2o-danube-3-4b", 160, 40),
                                ("whisper-base", 48, 4),
                                ("llama-3.2-vision-11b", 48, 4)):
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        cpu_params = init_params(cfg, 0, device="cpu")
        _set_gates(torch, cpu_params)
        gpu_params = params_from_jax(params_to_numpy(cpu_params), cfg, "cuda")
        tokens = np.random.default_rng(4).integers(0, cfg.vocab_size,
                                                   (2, prompt + steps))
        extra = synth_extra_inputs(cfg, 2, 1)
        card_extra = {k: v.to("cuda") for k, v in extra.items()}
        with torch.inference_mode():
            dec, ref = _decode_vs_prefill(
                torch, gpu_params, cfg, torch.as_tensor(tokens, device="cuda"),
                prefill_fn, decode_step_fn, card_extra, steps)
            torch.testing.assert_close(dec, ref, rtol=2e-3, atol=2e-3)
            got, _ = prefill_fn(gpu_params, {"tokens": torch.as_tensor(
                tokens[:, :prompt], device="cuda"), **card_extra}, cfg)
            want, _ = prefill_fn(cpu_params, {"tokens": torch.as_tensor(
                tokens[:, :prompt]), **extra}, cfg)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
        gen = {device: ServingEngine(cfg, params=params,
                                     device=device).generate(
            tokens[:, :prompt], max_new_tokens=8).cpu()
            for device, params in (("cuda", gpu_params), ("cpu", cpu_params))}
        if not torch.equal(gen["cuda"], gen["cpu"]):
            raise AssertionError(f"{arch}: greedy tokens differ: card "
                                 f"{gen['cuda'].tolist()} cpu "
                                 f"{gen['cpu'].tolist()}")
        gates = cpu_params["cross"]["gate"].tolist() \
            if "cross" in cpu_params else None
        print(f"{arch} smoke config, f32, gates {gates}: decode vs prefill on the card over {steps} steps from a "
              f"prompt of {prompt} (window {cfg.sliding_window}): max |diff| "
              f"{(dec - ref).abs().max().item()!r} within 2e-3; card vs CPU "
              f"prefill logits max |diff| "
              f"{(got.cpu() - want).abs().max().item()!r} within 1e-4; 8 "
              f"greedy tokens equal", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              f"from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.checksum import ops as fp_ops
    from repro_torch.kernels.checksum import ref as fp_ref
    from repro_torch.kernels.checksum.fingerprint import SOURCE as FP_SOURCE
    from repro_torch.kernels.checksum.fingerprint import fingerprint_u32
    from repro_torch.kernels.fused_ce import ce, fused_cross_entropy
    from repro_torch.kernels.fused_ce import ref as ce_ref
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    from repro_torch.kernels.ssd_scan import ssd, ssd_chunked
    from repro_torch.kernels.swa_attention import swa_attention
    from repro_torch.kernels.swa_attention import swa
    from repro_torch.kernels.swa_attention.ref import (swa_attention_bwd_ref,
                                                       swa_attention_ref)
    from repro_torch.models import decode_step_fn, init_params, prefill_fn
    from repro_torch.serving.engine import ServingEngine

    # f32 products in full f32 for every comparison below
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    print("== phase 1: card and kernel builds", flush=True)
    card = card_line()
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; card: {card}", flush=True)
    print(f"host memory: {_host_memory()} bytes", flush=True)
    sources = (swa.SOURCE, swa.BWD_SOURCE, ssd.SOURCE, ce.SOURCE, FP_SOURCE)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = list(pool.map(_build.build, sources))
    print(f"built {[lib.name for lib in libs]} from "
          f"{[str(s.relative_to(ROOT)) for s in sources]} in "
          f"{time.perf_counter() - t0:.2f} s, in parallel", flush=True)
    for lib in libs:
        print(lib.with_suffix(".log").read_text(), flush=True)

    swa_stats = phase_kernel(torch, swa_attention, swa_attention_ref)
    bwd_stats = phase_bwd_kernel(torch, swa.swa_flash, swa.swa_flash_bwd,
                                 swa_attention_bwd_ref)
    ssd_stats = phase_ssd_kernel(torch, ssd.ssd_intra_chunk, ssd_chunked,
                                 ssd_ref)
    ce_stats = phase_ce_kernel(torch, ce, ce_ref, fused_cross_entropy)
    fp_stats = phase_fingerprint_kernel(torch, fingerprint_u32, fp_ops, fp_ref)
    counters = {"swa_flash": swa.swa_flash,
                "swa_flash_bwd": swa.swa_flash_bwd,
                "ssd_intra_chunk": ssd.ssd_intra_chunk,
                "fused_ce_stats": ce.fused_ce_stats,
                "fingerprint_u32": fingerprint_u32}
    tools = (get_config, ServingEngine, prefill_fn, decode_step_fn)
    by_path = {arch: phase_serve(torch, card, arch, expected, counters, tools)
               for arch, expected in PATHS}
    phase_checks(torch, get_config, get_smoke_config, init_params,
                 prefill_fn, decode_step_fn, ServingEngine)
    per_slice = {}
    by_path[TRAIN_PATH], per_slice[TRAIN_PATH], rt, step_s = phase_train(
        torch, card, counters)
    phase_train_f32(TRAIN_PATH)
    phase_donate(torch)
    job = [rt]  # phase 5 takes the only reference, to free the source
    del rt
    by_path[MIGRATE_PATH] = phase_migrate(torch, card, counters, job, step_s)
    by_path[SSM_TRAIN_PATH], per_slice[SSM_TRAIN_PATH], rt, _ = phase_train(
        torch, card, counters, SSM_TRAIN_PATH)
    del rt
    torch.cuda.empty_cache()
    phase_train_f32(SSM_TRAIN_PATH)
    by_path[FLEET_PATH] = phase_fleet(torch, counters)
    for path in (HYBRID_TRAIN_PATH, MOE_TRAIN_PATH, AUDIO_TRAIN_PATH,
                 VLM_TRAIN_PATH):
        by_path[path], per_slice[path], rt, _ = phase_train(
            torch, card, counters, path)
        del rt
        torch.cuda.empty_cache()
        phase_train_f32(path)
    by_path[SIM_PATH] = phase_fleet_sim(counters)
    phase_dryrun(STATE_BYTES[MOE_TRAIN_PATH],
                 per_slice[MOE_TRAIN_PATH]["swa_flash"],
                 PEAK_BYTES[VLM_TRAIN_PATH][1])

    kernels = []
    for name, route, source, replaces, stats in (
            ("swa_flash", "cuda",
             "src/repro_torch/kernels/swa_attention/csrc/swa_flash.cu",
             "src/repro/kernels/swa_attention/swa.py:89", swa_stats),
            ("swa_flash_bwd", "cuda",
             "src/repro_torch/kernels/swa_attention/csrc/swa_flash_bwd.cu",
             "none: JAX differentiates its jnp attention through XLA",
             bwd_stats),
            ("ssd_intra_chunk", "cuda",
             "src/repro_torch/kernels/ssd_scan/csrc/ssd_intra_chunk.cu",
             "src/repro/kernels/ssd_scan/ssd.py:58", ssd_stats),
            ("fused_ce_stats", "cuda",
             "src/repro_torch/kernels/fused_ce/csrc/fused_ce_stats.cu",
             "src/repro/kernels/fused_ce/ce.py:67", ce_stats),
            ("fingerprint_u32", "cuda",
             "src/repro_torch/kernels/checksum/csrc/fingerprint_u32.cu",
             "src/repro/kernels/checksum/fingerprint.py:55", fp_stats)):
        paths = {arch: n[name] for arch, n in by_path.items() if n[name]}
        # each training path's launches a slice, as its steps counted them
        # (``launches_by_path`` sums its five steps, seven slices)
        slice_counts = {path: n[name] for path, n in per_slice.items()
                        if name in n}
        kernels.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces, "launches": sum(paths.values()),
            "launches_by_path": paths,
            "launches_per_slice_by_path": slice_counts,
            "max_abs_err": stats["max_abs_err"],
            "ms": stats["ms"], "plain_ms": stats["plain_ms"],
            "bound_ms": stats["bound_ms"], "bound_by": stats["bound_by"],
            "library_ms": stats["library_ms"],
            **{key: val for key, val in stats.items() if key not in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")},
        })
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
