"""Serving entry point: replica-group planning plus a smoke decode through the
port's ``ServingEngine`` (port of ``repro.launch.serve``).

1. **Plan** — derive the replica operating point for the *full* model
   config analytically (``ReplicaProfile.from_config`` against the H100
   ``GpuSpec``) and print the qps -> replicas curve.  Pure Python; runs
   anywhere.
2. **Smoke** — unless ``--plan-only``, generate through the real
   ``ServingEngine`` on the reduced smoke config, or with ``--full`` on the
   full config.  Runs on ``--device`` (default ``cuda``, which raises where
   there is no card).  Prompts are drawn from ``--seed`` with numpy.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b --full \\
        --batch 4 --prompt-len 512 --decode-tokens 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m --full
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch granite-moe-3b-a800m --full
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --arch zamba2-1.2b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-base \\
        --full --batch 4 --prompt-len 512 --decode-tokens 32
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch llama-3.2-vision-11b --full --prompt-len 512 --decode-tokens 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-3-4b \\
        --full --batch 2 --prompt-len 6144 --decode-tokens 32

``--arch`` takes any family: dense (olmo-1b and the other dense configs;
h2o-danube-3-4b serves past its 4,096-token window from a ring cache), moe
(granite-moe-3b-a800m, qwen3-moe-30b-a3b), ssm (mamba2-130m), hybrid
(zamba2-1.2b), audio (whisper-base) and VLM (llama-3.2-vision-11b).  The
engine draws the audio frames or image embeddings itself, from the seed;
their cross-attention gates are zero at init, so with fresh weights the
cross blocks add nothing until trained.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.serving.engine import ReplicaProfile, ServingEngine


def plan(args) -> None:
    cfg = get_config(args.arch)
    try:
        prof = ReplicaProfile.from_config(
            cfg,
            slo_ms=args.slo_ms,
            tokens_per_request=args.tokens_per_request,
        )
    except ValueError as e:
        print(f"plan: {args.arch} cannot meet p99 <= {args.slo_ms}ms: {e}")
        return
    print(
        f"plan[{cfg.name}]: slo={args.slo_ms}ms -> "
        f"{prof.gpus_per_replica} GPU(s)/replica, batch={prof.batch}, "
        f"p99 decode={prof.p99_decode_seconds * 1e3:.1f}ms, "
        f"{prof.tokens_per_second:.0f} tok/s, "
        f"{prof.qps_per_replica:.1f} qps/replica "
        f"({prof.weight_bytes / 2**30:.1f} GiB weights; analytic model "
        f"against the H100 data sheet, not a measurement)"
    )
    for qps in (args.qps * f for f in (0.25, 0.5, 1.0, 1.5, 2.0)):
        n = prof.replicas_for(qps, utilization=args.target_utilization)
        print(
            f"  {qps:10.1f} qps -> {n:4d} replicas "
            f"({n * prof.gpus_per_replica} GPUs at "
            f"rho={args.target_utilization})"
        )


def smoke(args) -> None:
    cfg = get_config(args.arch) if args.full else get_smoke_config(args.arch)
    engine = ServingEngine(cfg, seed=0, device=args.device)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len))
    t0 = time.perf_counter()
    out = engine.generate(
        prompts,
        max_new_tokens=args.decode_tokens,
        temperature=args.temperature,
    )
    out = out.cpu()  # waits for the device
    wall = time.perf_counter() - t0
    dev = engine.device
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(
        f"smoke[{cfg.name}]: batch={args.batch} prompt={args.prompt_len} "
        f"decode={args.decode_tokens}"
    )
    print("generated token ids (first row):", out[0].tolist())
    print(f"wall {wall:.2f}s  prefill+decode ran on {where} (first call: "
          f"kernel build and warm-up included on a card)")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--slo-ms", type=float, default=50.0)
    ap.add_argument("--tokens-per-request", type=int, default=128)
    ap.add_argument("--qps", type=float, default=1000.0)
    ap.add_argument("--target-utilization", type=float, default=0.75)
    ap.add_argument(
        "--plan-only",
        action="store_true",
        help="print the replica plan and skip the engine smoke decode",
    )
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--decode-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    args = ap.parse_args()

    plan(args)
    if not args.plan_only:
        smoke(args)


if __name__ == "__main__":
    main()
