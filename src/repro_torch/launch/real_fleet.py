"""The hierarchical scheduler driving REAL jobs (Figure 1, end to end), on
the port (port of ``examples/real_fleet.py``).

A 4-slot fleet runs an actual basic-tier training job; a premium job
arrives and the scheduler preempts the basic job THROUGH the real
mechanisms — the barrier carried by the step, a content-deduplicated
checkpoint — then restores it at the exact step once capacity frees up.
Every job trains on ``--device`` (default ``cuda``, which raises where
there is no card):

    PYTHONPATH=src python -m repro_torch.launch.real_fleet [--device cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.scheduler.executor import FleetExecutor, ManagedJob


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device of every job (default cuda; cpu runs "
                         "the plain versions of the kernels)")
    args = ap.parse_args(argv)

    ex = FleetExecutor(total_slots=4, device=args.device)
    ex.submit(ManagedJob(id="research-run", tier="basic",
                         arch="olmo-1b", world_size=4, total_steps=10))
    print(f"== basic job admitted at full scale (4 slots, on {ex.device}) ==")
    ex.tick(); ex.tick()
    j = ex.jobs["research-run"]
    print(f"  steps={j.steps_done} allocated={j.allocated}")

    print("== premium job arrives: fleet preempts the basic job ==")
    ex.submit(ManagedJob(id="prod-training", tier="premium",
                         arch="mamba2-130m", world_size=4, total_steps=6))
    ex.tick()
    print(f"  basic: allocated={j.allocated} preemptions={j.preemptions} "
          f"(checkpointed at step {j.steps_done} via in-graph barrier)")
    print(f"  premium: allocated={ex.jobs['prod-training'].allocated}")

    print("== run to completion ==")
    log = ex.run(max_ticks=40)
    for e in log:
        print(f"  {e}")
    for job in ex.jobs.values():
        print(f"  {job.id}: done={job.done} steps={job.steps_done} "
              f"preempt={job.preemptions} resize={job.resizes}")


if __name__ == "__main__":
    main()
