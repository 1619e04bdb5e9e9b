"""Singularity's core mechanisms (port of ``repro.core``), so far:

- ``barrier_step`` — the tandem meta-allreduce carried by the train step
  (§4.3.1), counterpart of ``repro.core.barrier_jax``;
- ``elastic``      — the transparent elastic runtime over the spliced step
  (§5).

Checkpoint, migration and the rest follow (ROADMAP M5).
"""
