"""The port's fleet executor against the JAX package's, on the CPU.

Each scenario of ``tests/test_executor.py`` (written once, in
``repro_torch.scheduler.scenarios``) runs twice: once on the JAX executor
and once on the port's ``FleetExecutor(device="cpu")``, with the
assertions of that file on both.  The executor's decisions depend on no
wall time and no loss value, so the two logs must be equal event for
event: preempt, restore at the exact step, resize, failure and rollback,
done.  The JAX runs are made once per module (they compile real models).
"""
import pytest
import torch

from repro.scheduler import executor as jax_executor
from repro.scheduler import job_table as jax_job_table
from repro_torch.scheduler import executor as pt_executor
from repro_torch.scheduler import job_table as pt_job_table
from repro_torch.scheduler import scenarios


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread (see ``tests/test_torch_donate.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SIDES = {"jax": (jax_executor, jax_job_table),
         "port": (pt_executor, pt_job_table)}


def _run(name, side):
    """The scenario ``name`` of ``repro_torch.scheduler.scenarios`` on one
    side: the port at device cpu, or the JAX executor (no device)."""
    ex_mod, table_mod = SIDES[side]
    return SCENARIOS[name](ex_mod.FleetExecutor, ex_mod.ManagedJob,
                           table_mod.TableJob,
                           "cpu" if side == "port" else None)


SCENARIOS = {fn.__name__: fn for fn in scenarios.SCENARIOS}


@pytest.fixture(scope="module")
def jax_logs():
    """Each scenario's log on the JAX executor, run once and kept."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _run(name, "jax")
        return cache[name]
    return get


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_port_log_equals_jax_log(jax_logs, name):
    got = _run(name, "port")
    assert got == jax_logs(name)
    assert {"preempt", "done"} <= {e["event"] for e in got}


def test_port_runtimes_run_on_the_executor_device():
    """Every job's runtime, restored ones too, holds its state on the
    executor's device; the store holds numpy."""
    ex = pt_executor.FleetExecutor(total_slots=2, device="cpu")
    ex.submit(pt_executor.ManagedJob(id="a", tier="basic", arch="mamba2-130m",
                                     world_size=2, total_steps=8))
    ex.tick()
    ex.submit(pt_executor.ManagedJob(id="b", tier="premium",
                                     arch="mamba2-130m", world_size=2,
                                     total_steps=1))
    ex.tick()
    assert ex.jobs["a"].runtime is None and "a" in ex.store.manifests
    device, _, _ = ex.store.restore("a")
    assert type(device[0]["params"]["embed"]).__module__ == "numpy"
    while "restore" not in [e["event"] for e in ex.log]:
        ex.tick()
    rt = ex.jobs["a"].runtime
    assert rt.device == ex.device == torch.device("cpu")
    assert rt.state["params"]["embed"].device == ex.device
    assert rt.state["step"].device == ex.device


def test_executor_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pt_executor.FleetExecutor(total_slots=2)


def test_real_fleet_command_runs_on_cpu(capsys):
    from repro_torch.launch import real_fleet

    real_fleet.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "on cpu" in out
    assert "{'event': 'restore', 'job': 'research-run', 'at_step': 4}" in out
    assert "research-run: done=True steps=10 preempt=1" in out


def test_real_fleet_command_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    from repro_torch.launch import real_fleet

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        real_fleet.main([])
