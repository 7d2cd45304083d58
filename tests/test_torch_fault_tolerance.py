"""The port's fault tolerance and fault injection, on the CPU, against
the JAX package's where they compute something.

``PreemptionHandler`` restores the previous handlers (also when the loop
raises); ``run_with_restarts`` recovers from a crash and returns the last
code once its budget is spent; ``StepWatchdog`` counts and reports steps
over budget; ``drop_slowest_aggregate`` averages tensor trees as JAX's
does over arrays; ``NonFiniteBatchInjector`` poisons the same batches as
JAX's; ``KillSwitch``'s gate is caller-armed and fires once.
"""
import os
import signal
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.testing import NonFiniteBatchInjector as JaxInjector
from repro.train import drop_slowest_aggregate as jax_drop_slowest
from repro_torch.data import (ClickLogLoader, SyntheticConfig,
                              generate_click_log)
from repro_torch.testing import KillSwitch, NonFiniteBatchInjector
from repro_torch.train import (PreemptionHandler, StepWatchdog,
                               drop_slowest_aggregate, run_with_restarts)


@pytest.fixture(scope="module")
def small_log():
    cfg = SyntheticConfig(n_sessions=600, n_queries=20, docs_per_query=10,
                          positions=5, behavior="pbm", seed=11)
    data, _ = generate_click_log(cfg)
    return cfg, data


def test_preemption_handler_context_manager_restores():
    before_term = signal.getsignal(signal.SIGTERM)
    before_int = signal.getsignal(signal.SIGINT)
    with PreemptionHandler() as h:
        assert signal.getsignal(signal.SIGTERM) is not before_term
        assert signal.getsignal(signal.SIGINT) is not before_int
        os.kill(os.getpid(), signal.SIGTERM)
        assert h.should_stop
    assert signal.getsignal(signal.SIGTERM) is before_term
    assert signal.getsignal(signal.SIGINT) is before_int


def test_preemption_handler_restores_on_exception():
    before = signal.getsignal(signal.SIGTERM)
    with pytest.raises(RuntimeError):
        with PreemptionHandler():
            raise RuntimeError("train loop blew up")
    assert signal.getsignal(signal.SIGTERM) is before


def test_run_with_restarts_recovers_from_crash(tmp_path):
    marker = tmp_path / "crashed_once"
    script = tmp_path / "flaky.py"
    script.write_text(
        "import os, sys\n"
        f"m = {str(marker)!r}\n"
        "if not os.path.exists(m):\n"
        "    open(m, 'w').close()\n"
        "    sys.exit(137)\n"
        "print('done')\n")
    logs = []
    rc = run_with_restarts([sys.executable, str(script)], max_restarts=2,
                           log_fn=logs.append)
    assert rc == 0
    assert any("relaunching" in m for m in logs)
    assert any("completed after 1 restart" in m for m in logs)


def test_run_with_restarts_budget_exhausted(tmp_path):
    script = tmp_path / "always_dies.py"
    script.write_text("import sys; sys.exit(3)\n")
    logs = []
    rc = run_with_restarts([sys.executable, str(script)], max_restarts=1,
                           log_fn=logs.append)
    assert rc == 3
    assert any("exhausted" in m for m in logs)


def test_step_watchdog_counts_and_reports_violations():
    seen = []
    wd = StepWatchdog(0.5, on_violation=lambda step, sec: seen.append(
        (step, sec)))
    assert wd.check(0.1, 4) == 0
    assert wd.check(0.7, 8) == 1
    assert wd.check(0.5, 12) == 1  # at the budget is not over it
    assert wd.check(2.0, 16) == 2
    assert seen == [(8, 0.7), (16, 2.0)]


def test_drop_slowest_aggregate_matches_jax():
    rng = np.random.default_rng(0)
    grads = [{"w": rng.normal(size=3).astype(np.float32),
              "b": {"c": rng.normal(size=(2, 2)).astype(np.float32)}}
             for _ in range(3)]
    arrived = [True, False, True]
    got = drop_slowest_aggregate(
        [{"w": torch.from_numpy(g["w"]),
          "b": {"c": torch.from_numpy(g["b"]["c"])}} for g in grads],
        arrived)
    want = jax_drop_slowest(
        [{"w": jnp.asarray(g["w"]), "b": {"c": jnp.asarray(g["b"]["c"])}}
         for g in grads], arrived)
    np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]),
                               rtol=1e-6)
    np.testing.assert_allclose(got["b"]["c"].numpy(),
                               np.asarray(want["b"]["c"]), rtol=1e-6)
    with pytest.raises(RuntimeError):
        drop_slowest_aggregate(grads[:1], arrived=[False])


def test_nonfinite_injector_poisons_the_batches_jax_poisons(small_log):
    _, data = small_log

    def run(cls):
        inj = cls(ClickLogLoader(data, batch_size=64, seed=5),
                  at_steps=[1, 3], key="clicks")
        batches = list(iter(inj)) + list(iter(inj))  # two epochs
        return inj, batches

    inj, got = run(NonFiniteBatchInjector)
    jinj, want = run(JaxInjector)
    assert inj.injected == jinj.injected == 2
    assert inj.produced == jinj.produced == len(got) == len(want)
    assert np.isnan(got[1]["clicks"]).all()
    assert np.isfinite(got[0]["clicks"]).all()
    for a, b in zip(got, want):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert inj.batch_size == 64  # the proxy forwards attributes
    assert inj.state_dict() == {"epoch": 2, "step": 0}


def test_killswitch_caller_armed_gate(small_log):
    """Disarmed, inert through any number of batches; after arm() it fires
    exactly once at the pinned batch. SIGTERM is absorbed by a
    PreemptionHandler so the gate is testable in-process."""
    _, data = small_log
    ks = KillSwitch(ClickLogLoader(data, batch_size=64, seed=5),
                    after_batches=0, sig=signal.SIGTERM, armed=False)
    with PreemptionHandler() as h:
        for _ in ks:
            pass
        assert not ks.fired and not h.should_stop
        ks.arm()
        ks.produced = 0
        next(iter(ks))
        assert ks.fired and h.should_stop
        h.should_stop = False
        ks.produced = 0
        next(iter(ks))
        assert not h.should_stop
