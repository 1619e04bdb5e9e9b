"""End-to-end elastic training driver (port of ``repro.launch.train``).

Trains a model for N steps through the port's elastic runtime (logical
world size, splice factor), the barrier carried by the step, and optional
mid-run resizes: the paper's §2 lifecycle as one command, on ``--device``
(default ``cuda``, which raises where there is no card).

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --steps 4 --resize 2:2
    PYTHONPATH=src python -m repro_torch.launch.train --full \\
        --global-batch 4 --seq-len 4096 --steps 5 --resize 3:2

    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-1.2b \\
        --full --global-batch 4 --seq-len 4096 --steps 5 --resize 3:2
    PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-base \\
        --full --global-batch 4 --seq-len 4096 --steps 5 --resize 3:2

Without ``--full`` it trains the reduced smoke config.  The port trains the
families dense (olmo-1b and the other dense configs), moe
(``--arch granite-moe-3b-a800m``, qwen3-moe-30b-a3b), ssm
(``--arch mamba2-130m``), hybrid (``--arch zamba2-1.2b``), audio
(``--arch whisper-base``; the runtime draws the encoder frames once from
the seed) and VLM (``--arch llama-3.2-vision-11b``, its image embeddings
likewise; at full width its f32 weights and AdamW moments do not fit one
80 GB card).
``--donate`` writes the update into the state itself (JAX's
``donate_argnums``) and not into a new one: 16 bytes a parameter where the
functional step holds 28, so that
granite-moe-3b-a800m trains at all 32 layers on one 80 GB card
(``--arch granite-moe-3b-a800m --full --donate``).  ``--layers N`` cuts
the depth.  ``--ckpt-every N``
takes a transparent checkpoint of every logical worker every N steps into
an in-memory content-deduped store, as the JAX command does.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import TrainConfig
from repro_torch.core.checkpoint import CheckpointStore
from repro_torch.core.elastic import ElasticRuntime
from repro_torch.core.migration import checkpoint_job


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--full", action="store_true",
                    help="use the full config (default: reduced smoke)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the config to this many layers (0: keep)")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--world", type=int, default=4,
                    help="logical world size (constant for the job)")
    ap.add_argument("--physical", type=int, default=4)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--donate", action="store_true",
                    help="update the state itself (16 bytes a parameter)")
    ap.add_argument("--resize", action="append", default=[],
                    help="step:new_physical (repeatable)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "versions of the kernels)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    if args.ckpt_every < 0:
        ap.error(f"--ckpt-every must be >= 0 (0: no checkpoints); got "
                 f"{args.ckpt_every}")
    cfg = get_config(args.arch) if args.full else get_smoke_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    tcfg = TrainConfig(total_steps=args.steps, warmup_steps=2,
                       learning_rate=args.lr)
    resizes = {}
    for r in args.resize:
        step, phys = r.split(":")
        resizes[int(step)] = int(phys)

    rt = ElasticRuntime(cfg, tcfg, args.world, args.physical,
                        args.global_batch, args.seq_len, device=args.device,
                        donate=args.donate)
    store = CheckpointStore()
    t0 = time.time()
    events = []
    while int(rt.state["step"]) < args.steps:
        step = int(rt.state["step"])
        if step in resizes:
            ev = rt.resize(resizes[step])
            print(f"[resize] {ev}")
            events.append({"resize": ev})
        if args.ckpt_every and step and step % args.ckpt_every == 0:
            stats = checkpoint_job(rt, store, f"train-{args.arch}")
            print(f"[ckpt] step={step} stored={stats.device_stored_bytes/1e6:.1f}MB "
                  f"(logical {stats.device_logical_bytes/1e6:.1f}MB, "
                  f"{stats.n_workers} workers)")
        rec = rt.run_steps(1)[0]
        print(f"step {rec['step']:4d} loss={rec['loss']:.4f} "
              f"grad_norm={rec['grad_norm']:.4f} "
              f"splice={rec['splice']} physical={rec['physical']}")
    wall = time.time() - t0
    print(f"done: {args.steps} steps in {wall:.1f}s on {rt.device}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"history": rt.history, "events": events,
                       "wall_seconds": wall}, f, indent=2)


if __name__ == "__main__":
    main()
