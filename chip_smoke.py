#!/usr/bin/env python3
"""Bring-up check of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, each of which raises on failure (the exit code is then non-zero):

1. Print the card (``nvidia-smi``), build the hand-written CUDA kernels
   from the repository's sources (one ``nvcc`` per source, all started
   together) and print the build time and the compiler's register report.
2. Hold ``swa_flash`` against its plain PyTorch version on the card at the
   olmo serving shape (bf16 and f32) and at two ragged/windowed shapes,
   then time the kernel, the plain version and PyTorch's
   ``scaled_dot_product_attention`` (the yardstick; the port never calls
   it) beside the kernel's bound.
2b. Hold ``ssd_intra_chunk`` against its plain version at the mamba2-130m
   serving shape (bf16 and f32) and the zamba2-1.2b one; run the whole SSD
   wrapper at a ragged length against the plain chunked scan, the O(L)
   recurrence and its own ``initial_state`` continuation; time the kernel
   and the plain version beside the kernel's bound (no PyTorch call
   computes this function).
3. Drive the port's serving paths at full width, each through
   ``ServingEngine``, which generates 32 greedy tokens for 4 prompts of
   512 with random weights from seed 0: olmo-1b (16 layers, d_model 2048,
   bf16), then mamba2-130m (24 layers, d_model 768, bf16), then
   zamba2-1.2b (38 Mamba2 layers and 6 applications of one shared
   attention block, d_model 2048, bf16).  Every kernel's launch count is
   set to 0 just before each path and read just after: olmo launches
   ``swa_flash`` once per layer; mamba2 ``ssd_intra_chunk`` once per layer;
   zamba2 both, once per Mamba2 layer and once per shared block.  Then time
   prefill and decode, profile one of each, and check decode-vs-prefill at
   bf16.
3b. f32 checks: decode-vs-prefill at full width for each model, and the
   card path against the CPU path on the olmo and mamba2 smoke configs.
4. Print the ``kernels`` JSON line, the card's name and power limit, and as
   the last line ``{"ok": true, "device": {...}}``.

It imports no JAX and nothing of the JAX package ``repro``.
"""
from __future__ import annotations

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
]
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
]
SSD_TOL = dict(rtol=1e-4, atol=1e-4)
SSD_RAGGED = (1, 200, 2, 64, 32, 64)     # (B, L, H, P, N, chunk): wrapper

BATCH, PROMPT, NEW_TOKENS = 4, 512, 32
# the serving paths, each with its kernels' launches per prefill
PATHS = [
    ("olmo-1b", {"swa_flash": 16, "ssd_intra_chunk": 0}),
    ("mamba2-130m", {"swa_flash": 0, "ssd_intra_chunk": 24}),
    ("zamba2-1.2b", {"swa_flash": 6, "ssd_intra_chunk": 38}),
]


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


def _peak_flops(torch, dtype):
    from repro_torch.utils import constants

    return {torch.bfloat16: constants.DATASHEET_PEAK_BF16_FLOPS,
            torch.float32: constants.DATASHEET_PEAK_F32_FLOPS}[dtype]


def _bound(t_bytes: float, t_ops: float):
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def causal_pairs(s: int, window: int) -> int:
    """(query, key) pairs the causal (windowed) mask keeps."""
    if window <= 0:
        return s * (s + 1) // 2
    return sum(min(i + 1, window) for i in range(s))


def attention_bound(torch, b, s, h, d, window, dtype):
    """Least time for the function on an H100 SXM (data sheet): q, k, v
    read once and o written once over the HBM rate, against 2 products of
    2 flops per kept (query, key) pair and head dim over the dense peak of
    the operand type.  Returns (ms, "bytes" | "operations")."""
    from repro_torch.utils import constants

    elsize = torch.empty((), dtype=dtype).element_size()
    t_bytes = 4 * b * s * h * d * elsize / constants.DATASHEET_HBM_BANDWIDTH
    t_ops = 4 * d * causal_pairs(s, window) * b * h / _peak_flops(torch, dtype)
    return _bound(t_bytes, t_ops)


def ssd_bound(torch, bc, q, h, p, n, dtype):
    """Least time for ``ssd_intra_chunk`` on an H100 SXM (data sheet): x, b,
    c (``dtype``), dt and a (f32) read once and y, states and cum (f32)
    written once over the HBM rate, against its products over the dense
    peak of the operand type: C B^T once per chunk over the causal pairs,
    M x over the causal pairs per head, x^T (w B) in full per head.
    Returns (ms, "bytes" | "operations")."""
    from repro_torch.utils import constants

    elsize = torch.empty((), dtype=dtype).element_size()
    read = elsize * bc * q * (h * p + 2 * n) + 4 * (bc * q * h + h)
    written = 4 * (bc * q * h * p + bc * h * p * n + bc * q * h)
    t_bytes = (read + written) / constants.DATASHEET_HBM_BANDWIDTH
    pairs = q * (q + 1) // 2
    flops = 2 * bc * (n * pairs + h * p * pairs + h * q * p * n)
    return _bound(t_bytes, flops / _peak_flops(torch, dtype))


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
    dtype = getattr(torch, dname)
    q, k, v = (torch.randn(b, s, h, d, generator=gen, device=dev).to(dtype)
               for _ in range(3))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kernel_ms = time_ms(torch, lambda: swa_attention(q, k, v, window=w), 200)
    plain_ms = time_ms(torch, lambda: swa_attention_ref(qt, kt, vt, window=w),
                       20)
    library_ms = time_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=True), 200)
    kernel_ms_2 = time_ms(torch, lambda: swa_attention(q, k, v, window=w), 200)
    bound_ms, bound_by = attention_bound(torch, b, s, h, d, w, dtype)
    print(f"times at B={b} S={s} H={h} D={d} window={w} {dname} (mean of "
          f"back-to-back launches; q/k/v/o, {4 * q.numel() * q.element_size()}"
          f" bytes, fit the 50 MB L2): "
          f"kernel {kernel_ms!r} ms then {kernel_ms_2!r} ms, plain "
          f"{plain_ms!r} ms, scaled_dot_product_attention {library_ms!r} ms, "
          f"bound {bound_ms!r} ms ({bound_by})", flush=True)
    return dict(max_abs_err=main_err, ms=(kernel_ms + kernel_ms_2) / 2,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms)


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

    # times at the mamba2 shape (the kernels line) and the zamba2 one
    times = [_time_ssd(torch, gen, ssd_intra_chunk, ref, case)
             for case in (SSD_CASES[0], SSD_CASES[2])]
    return dict(times[0], max_abs_err=main_err, library_ms=None)


def _time_ssd(torch, gen, ssd_intra_chunk, ref, case):
    bc, q, h, p, n, dname = case
    dtype = getattr(torch, dname)
    inputs = _ssd_inputs(torch, gen, bc, q, h, p, n, dtype)
    kernel_ms = time_ms(torch, lambda: ssd_intra_chunk(*inputs), 100)
    plain_ms = time_ms(torch, lambda: ref.ssd_intra_chunk_ref(*inputs), 10)
    kernel_ms_2 = time_ms(torch, lambda: ssd_intra_chunk(*inputs), 100)
    bound_ms, bound_by = ssd_bound(torch, bc, q, h, p, n, dtype)
    print(f"times at BC={bc} Q={q} H={h} P={p} N={n} {dname} (mean of "
          f"back-to-back launches): kernel {kernel_ms!r} ms then "
          f"{kernel_ms_2!r} ms, plain {plain_ms!r} ms, bound {bound_ms!r} ms "
          f"({bound_by}); no PyTorch call computes this function", flush=True)
    return dict(ms=(kernel_ms + kernel_ms_2) / 2, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def phase_serve(torch, card, arch, expected, counters, tools):
    """One serving path at full width; returns its launch counts."""
    get_config, ServingEngine, prefill_fn, decode_step_fn = tools
    print(f"\n== phase 3: {arch} at full width through ServingEngine",
          flush=True)
    cfg = get_config(arch)
    t0 = time.perf_counter()
    engine = ServingEngine(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"{cfg.name} [{cfg.arch_type}]: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab_size}, {cfg.dtype}: "
          f"{cfg.param_count()} parameters, made in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (BATCH, PROMPT + 1))

    # the main path: counts to 0 just before, read just after
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    out = engine.generate(prompts[:, :PROMPT], max_new_tokens=NEW_TOKENS)
    out = out.cpu()
    first_wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    peak_bytes = torch.cuda.max_memory_allocated()
    print(f"generate(batch {BATCH}, prompt {PROMPT}, {NEW_TOKENS} new, "
          f"greedy): launches {launches}, first call {first_wall:.3f} s",
          flush=True)
    if launches != expected:
        raise AssertionError(f"expected launches {expected} in one prefill "
                             f"of {arch}, saw {launches}")
    if out.shape != (BATCH, NEW_TOKENS):
        raise AssertionError(f"generated shape {tuple(out.shape)}")
    if not ((out >= 0) & (out < cfg.vocab_size)).all():
        raise AssertionError("generated token ids out of range")
    print("generated ids (first row):", out[0].tolist(), flush=True)

    with torch.inference_mode():
        tokens = torch.as_tensor(prompts, device="cuda")
        batch = {"tokens": tokens[:, :PROMPT]}
        prefill_ms = time_ms(
            torch, lambda: prefill_fn(engine.params, batch, cfg,
                                      cache_len=PROMPT + NEW_TOKENS), 5, 1)
        logits, state = prefill_fn(engine.params, batch, cfg,
                                   cache_len=PROMPT + NEW_TOKENS)
        if logits.shape != (BATCH, cfg.vocab_size) or \
                logits.dtype != torch.float32:
            raise AssertionError(f"logits {tuple(logits.shape)} {logits.dtype}")
        if not torch.isfinite(logits).all():
            raise AssertionError("non-finite prefill logits")
        tok = logits.argmax(-1)
        steps = NEW_TOKENS - 1
        decode_ms = time_ms(
            torch, lambda: decode_step_fn(engine.params, state, tok, cfg),
            steps, 0)
        _profile(torch, f"{arch} prefill (batch {BATCH} x {PROMPT})",
                 lambda: prefill_fn(engine.params, batch, cfg,
                                    cache_len=PROMPT + NEW_TOKENS))
        _profile(torch, f"{arch} decode step (batch {BATCH})",
                 lambda: decode_step_fn(engine.params, state, tok, cfg))
    t0 = time.perf_counter()
    engine.generate(prompts[:, :PROMPT], max_new_tokens=NEW_TOKENS).cpu()
    warm_wall = time.perf_counter() - t0
    print(f"[{card}] {arch}: prefill {prefill_ms!r} ms (batch {BATCH} x "
          f"{PROMPT}); decode {decode_ms!r} ms/token step (batch {BATCH}), "
          f"{BATCH * 1e3 / decode_ms!r} tokens/s; generate warm "
          f"{warm_wall!r} s = {BATCH * NEW_TOKENS / warm_wall!r} new tokens/s;"
          f" peak device memory {peak_bytes} bytes", flush=True)

    # decode-vs-prefill at full width, bf16: prefill(s) + one decode step
    # against prefill(s + 1).  The two paths round bf16 activations at other
    # places through every layer; that moved the largest of 4 x 50304
    # olmo-1b logits by 0.126 in this script's first run (spread of the
    # logits about 1).  A fault of structure (cache slot, mask, position,
    # carried SSM state) moves logits by their own spread.  So the bound is
    # a quarter of the logits' standard deviation; the tight check is the
    # f32 one in phase 3b.
    with torch.inference_mode():
        dec, ref = _decode_vs_prefill(torch, engine.params, cfg, tokens,
                                      prefill_fn, decode_step_fn)
    diff = (dec - ref).abs()
    err, bound = diff.max().item(), 0.25 * ref.std().item()
    print(f"{arch} decode vs prefill, bf16, batch {BATCH}, prompt {PROMPT}: "
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


def _decode_vs_prefill(torch, params, cfg, tokens, prefill_fn,
                       decode_step_fn):
    s = tokens.shape[1] - 1
    _, state = prefill_fn(params, {"tokens": tokens[:, :s]}, cfg,
                          cache_len=s + 1)
    dec, _ = decode_step_fn(params, state, tokens[:, s], cfg)
    ref, _ = prefill_fn(params, {"tokens": tokens}, cfg)
    return dec, ref


def phase_checks(torch, get_config, get_smoke_config, init_params,
                 prefill_fn, decode_step_fn, ServingEngine):
    from repro_torch.bridge import params_from_jax, params_to_numpy

    print("\n== phase 3b: f32 checks", flush=True)
    # decode-vs-prefill at full width in f32 (tests/test_decode_consistency
    # bound, 2e-3); the SSM models on a prompt of 256, two whole chunks, so
    # that the decode step's prefill(257) has a ragged third chunk
    for arch, prompt in (("olmo-1b", 128), ("mamba2-130m", 256),
                         ("zamba2-1.2b", 256)):
        cfg = dataclasses.replace(get_config(arch), dtype="float32")
        params = init_params(cfg, 0, device="cuda")
        tokens = torch.as_tensor(np.random.default_rng(2).integers(
            0, cfg.vocab_size, (2, prompt + 1)), device="cuda")
        with torch.inference_mode():
            dec, ref = _decode_vs_prefill(torch, params, cfg, tokens,
                                          prefill_fn, decode_step_fn)
        torch.testing.assert_close(dec, ref, rtol=2e-3, atol=2e-3)
        print(f"{arch} decode vs prefill, f32, full width, batch 2, prompt "
              f"{prompt}: max |diff| {(dec - ref).abs().max().item()!r} "
              f"within 2e-3", flush=True)
        del params
        torch.cuda.empty_cache()

    # the card path (CUDA kernels) against the CPU path (plain versions) on
    # the smoke configs, same weights, f32: logits within 1e-4 and the same
    # greedy tokens
    for arch in ("olmo-1b", "mamba2-130m"):
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
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    from repro_torch.kernels.ssd_scan import ssd, ssd_chunked
    from repro_torch.kernels.swa_attention import swa_attention
    from repro_torch.kernels.swa_attention import swa
    from repro_torch.kernels.swa_attention.ref import swa_attention_ref
    from repro_torch.models import decode_step_fn, init_params, prefill_fn
    from repro_torch.serving.engine import ServingEngine

    # f32 products in full f32 for every comparison below
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    print("== phase 1: card and kernel builds", flush=True)
    card = card_line()
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; card: {card}", flush=True)
    sources = (swa.SOURCE, ssd.SOURCE)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = list(pool.map(_build.build, sources))
    print(f"built {[lib.name for lib in libs]} from "
          f"{[str(s.relative_to(ROOT)) for s in sources]} in "
          f"{time.perf_counter() - t0:.2f} s, in parallel", flush=True)
    for lib in libs:
        print(lib.with_suffix(".log").read_text(), flush=True)

    swa_stats = phase_kernel(torch, swa_attention, swa_attention_ref)
    ssd_stats = phase_ssd_kernel(torch, ssd.ssd_intra_chunk, ssd_chunked,
                                 ssd_ref)
    counters = {"swa_flash": swa.swa_flash,
                "ssd_intra_chunk": ssd.ssd_intra_chunk}
    tools = (get_config, ServingEngine, prefill_fn, decode_step_fn)
    by_path = {arch: phase_serve(torch, card, arch, expected, counters, tools)
               for arch, expected in PATHS}
    phase_checks(torch, get_config, get_smoke_config, init_params,
                 prefill_fn, decode_step_fn, ServingEngine)

    kernels = []
    for name, route, source, replaces, stats in (
            ("swa_flash", "cuda",
             "src/repro_torch/kernels/swa_attention/csrc/swa_flash.cu",
             "src/repro/kernels/swa_attention/swa.py:89", swa_stats),
            ("ssd_intra_chunk", "cuda",
             "src/repro_torch/kernels/ssd_scan/csrc/ssd_intra_chunk.cu",
             "src/repro/kernels/ssd_scan/ssd.py:58", ssd_stats)):
        paths = {arch: n[name] for arch, n in by_path.items() if n[name]}
        kernels.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces, "launches": sum(paths.values()),
            "launches_by_path": paths, "max_abs_err": stats["max_abs_err"],
            "ms": stats["ms"], "plain_ms": stats["plain_ms"],
            "bound_ms": stats["bound_ms"], "bound_by": stats["bound_by"],
            "library_ms": stats["library_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
