#!/usr/bin/env python3
"""Bring-up check of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, each of which raises on failure (the exit code is then non-zero):

1. Print the card (``nvidia-smi``), build the hand-written CUDA kernel from
   the repository's source and print the build time and the compiler's
   register report.
2. Hold the kernel against its plain PyTorch version on the card at the
   serving path's shape (bf16 and f32) and at two ragged/windowed shapes,
   then time the kernel, the plain version and PyTorch's
   ``scaled_dot_product_attention`` (the yardstick; the port never calls
   it) beside the kernel's bound.
3. Drive the port's serving path at full width: ``ServingEngine`` for
   olmo-1b (16 layers, d_model 2048, bf16, random weights from seed 0)
   generates 32 greedy tokens for 4 prompts of 512.  The kernel's launch
   count is set to 0 just before and read just after: one launch per layer.
   Then time prefill and decode, and check the output: token ids in range,
   finite logits, decode-vs-prefill agreement at full width (bf16 and f32),
   and the card path against the CPU path on the olmo smoke config.
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
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# kernel vs plain version on the card: (B, S, H, D, window, dtype name)
KERNEL_CASES = [
    (4, 512, 16, 128, 0, "bfloat16"),   # the serving path's shape
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

BATCH, PROMPT, NEW_TOKENS = 4, 512, 32


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

    peak = {torch.bfloat16: constants.DATASHEET_PEAK_BF16_FLOPS,
            torch.float32: constants.DATASHEET_PEAK_F32_FLOPS}[dtype]
    elsize = torch.empty((), dtype=dtype).element_size()
    t_bytes = 4 * b * s * h * d * elsize / constants.DATASHEET_HBM_BANDWIDTH
    t_ops = 4 * d * causal_pairs(s, window) * b * h / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


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


def phase_serve(torch, card, swa_flash, ServingEngine, get_config,
                prefill_fn, decode_step_fn):
    print("\n== phase 3: olmo-1b at full width through ServingEngine",
          flush=True)
    cfg = get_config("olmo-1b")
    t0 = time.perf_counter()
    engine = ServingEngine(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"{cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads} heads of {cfg.resolved_head_dim()}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}: "
          f"{cfg.param_count()} parameters, made in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (BATCH, PROMPT + 1))

    # the main path: counts to 0 just before, read just after
    torch.cuda.reset_peak_memory_stats()
    swa_flash.launches = 0
    t0 = time.perf_counter()
    out = engine.generate(prompts[:, :PROMPT], max_new_tokens=NEW_TOKENS)
    out = out.cpu()
    first_wall = time.perf_counter() - t0
    launches = swa_flash.launches
    peak_bytes = torch.cuda.max_memory_allocated()
    print(f"generate(batch {BATCH}, prompt {PROMPT}, {NEW_TOKENS} new, "
          f"greedy): swa_flash launches {launches}, first call "
          f"{first_wall:.3f} s", flush=True)
    if launches != cfg.num_layers:
        raise AssertionError(f"expected {cfg.num_layers} swa_flash launches "
                             f"(one per layer) in one prefill, saw {launches}")
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
        _profile(torch, f"prefill (batch {BATCH} x {PROMPT})",
                 lambda: prefill_fn(engine.params, batch, cfg,
                                    cache_len=PROMPT + NEW_TOKENS))
        _profile(torch, f"decode step (batch {BATCH})",
                 lambda: decode_step_fn(engine.params, state, tok, cfg))
    t0 = time.perf_counter()
    engine.generate(prompts[:, :PROMPT], max_new_tokens=NEW_TOKENS).cpu()
    warm_wall = time.perf_counter() - t0
    print(f"[{card}] prefill {prefill_ms!r} ms (batch {BATCH} x {PROMPT}); "
          f"decode {decode_ms!r} ms/token step (batch {BATCH}), "
          f"{BATCH * 1e3 / decode_ms!r} tokens/s; generate warm "
          f"{warm_wall!r} s = {BATCH * NEW_TOKENS / warm_wall!r} new tokens/s;"
          f" peak device memory {peak_bytes} bytes", flush=True)

    # decode-vs-prefill at full width, bf16: prefill(s) + one decode step
    # against prefill(s + 1).  The two paths round bf16 activations at other
    # places through 16 layers; that moved the largest of 4 x 50304 logits
    # by 0.126 in this script's first run (spread of the logits about 1).
    # A fault of structure (cache slot, mask, position) moves logits by
    # their own spread.  So the bound is a quarter of the logits' standard
    # deviation; the tight check is the f32 one in phase 3b.
    with torch.inference_mode():
        dec, ref = _decode_vs_prefill(torch, engine.params, cfg, tokens,
                                      prefill_fn, decode_step_fn)
    diff = (dec - ref).abs()
    err, bound = diff.max().item(), 0.25 * ref.std().item()
    print(f"decode vs prefill, bf16, batch {BATCH}, prompt {PROMPT}: max "
          f"|diff| {err!r}, mean |diff| {diff.mean().item()!r}, logits std "
          f"{ref.std().item()!r}, max |logit| {ref.abs().max().item()!r}; "
          f"bound {bound!r}", flush=True)
    if not math.isfinite(err) or err > bound:
        raise AssertionError(f"decode vs prefill at bf16 differs by {err}")
    del engine, state, logits
    torch.cuda.empty_cache()
    return dict(launches=launches)


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
    # bound, 2e-3), on a shorter prompt
    cfg = dataclasses.replace(get_config("olmo-1b"), dtype="float32")
    params = init_params(cfg, 0, device="cuda")
    tokens = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 129)), device="cuda")
    with torch.inference_mode():
        dec, ref = _decode_vs_prefill(torch, params, cfg, tokens, prefill_fn,
                                      decode_step_fn)
    torch.testing.assert_close(dec, ref, rtol=2e-3, atol=2e-3)
    print(f"decode vs prefill, f32, full width, batch 2, prompt 128: max "
          f"|diff| {(dec - ref).abs().max().item()!r} within 2e-3", flush=True)
    del params
    torch.cuda.empty_cache()

    # the card path (CUDA kernel) against the CPU path (plain version) on
    # the olmo smoke config, same weights, f32: logits within 1e-4 and the
    # same greedy tokens
    cfg = dataclasses.replace(get_smoke_config("olmo-1b"), dtype="float32")
    cpu_params = init_params(cfg, 0, device="cpu")
    gpu_params = params_from_jax(params_to_numpy(cpu_params), cfg, "cuda")
    prompts = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 48))
    with torch.inference_mode():
        got, _ = prefill_fn(gpu_params, {"tokens": torch.as_tensor(
            prompts, device="cuda")}, cfg)
        want, _ = prefill_fn(cpu_params, {"tokens": torch.as_tensor(prompts)},
                             cfg)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    gen_gpu = ServingEngine(cfg, params=gpu_params, device="cuda").generate(
        prompts, max_new_tokens=8).cpu()
    gen_cpu = ServingEngine(cfg, params=cpu_params, device="cpu").generate(
        prompts, max_new_tokens=8)
    if not torch.equal(gen_gpu, gen_cpu):
        raise AssertionError(f"greedy tokens differ: card {gen_gpu.tolist()}"
                             f" cpu {gen_cpu.tolist()}")
    print(f"smoke config, f32: card vs CPU prefill logits max |diff| "
          f"{(got.cpu() - want).abs().max().item()!r} within 1e-4; 8 greedy "
          f"tokens equal", flush=True)


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
    from repro_torch.kernels.swa_attention import swa_attention
    from repro_torch.kernels.swa_attention import swa
    from repro_torch.kernels.swa_attention.ref import swa_attention_ref
    from repro_torch.models import decode_step_fn, init_params, prefill_fn
    from repro_torch.serving.engine import ServingEngine

    # f32 products in full f32 for every comparison below
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    print("== phase 1: card and kernel build", flush=True)
    card = card_line()
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; card: {card}", flush=True)
    t0 = time.perf_counter()
    lib = _build.build(swa.SOURCE)
    print(f"built {lib.name} from {swa.SOURCE.relative_to(ROOT)} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    print(lib.with_suffix(".log").read_text(), flush=True)

    stats = phase_kernel(torch, swa_attention, swa_attention_ref)
    stats.update(phase_serve(torch, card, swa.swa_flash, ServingEngine,
                             get_config, prefill_fn, decode_step_fn))
    phase_checks(torch, get_config, get_smoke_config, init_params,
                 prefill_fn, decode_step_fn, ServingEngine)

    kernel = {
        "name": "swa_flash", "route": "cuda",
        "source": "src/repro_torch/kernels/swa_attention/csrc/swa_flash.cu",
        "replaces": "src/repro/kernels/swa_attention/swa.py:89",
        "launches": stats["launches"], "max_abs_err": stats["max_abs_err"],
        "ms": stats["ms"], "plain_ms": stats["plain_ms"],
        "bound_ms": stats["bound_ms"], "bound_by": stats["bound_by"],
        "library_ms": stats["library_ms"],
    }
    print(json.dumps({"kernels": [kernel]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
