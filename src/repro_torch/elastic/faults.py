"""Deterministic fault injection: preempt a training run at a chosen
step (port of ``repro.elastic.faults``).

The paper's fault-tolerance story (§2.2: ULFM survives a rank failure)
is only testable if failures are *reproducible*.  A
:class:`FaultInjector` kills the process at an exact step boundary --
by default with ``os._exit``, the closest userspace analogue of a
preemption/SIGKILL: no ``atexit`` handlers, no thread joins, no
buffered-file flushing, so a mid-write background checkpointer leaves
exactly the torn ``tmp-`` staging state a real kill would.  The tests
drive it in subprocesses: spawn a run with ``REPRO_FAULT_STEP`` set (or
``--fault-step``), assert the exit code, then resume from what was
*published*.

``mode="raise"`` throws :class:`SimulatedFault` instead -- an in-process
soft failure for exercising recovery paths under pytest without a
subprocess.
"""
from __future__ import annotations

import dataclasses
import os
import sys
from typing import Optional

#: default exit status for an injected kill -- distinct from Python
#: tracebacks (1) and shell "command not found" (127) so the test
#: harness can assert the fault fired rather than the run crashing
FAULT_EXIT_CODE = 113

ENV_STEP = "REPRO_FAULT_STEP"
ENV_MODE = "REPRO_FAULT_MODE"


class SimulatedFault(RuntimeError):
    """Raised by ``mode="raise"`` injectors at the planned step."""


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """When and how to die.  ``kill_at_step`` is compared against the
    step index passed to ``after_step`` -- the fault fires at the FIRST
    boundary where ``step >= kill_at_step``, so a plan outlives
    restarts/resumes without re-counting."""
    kill_at_step: int
    mode: str = "exit"                 # "exit" (hard, os._exit) | "raise"
    exit_code: int = FAULT_EXIT_CODE

    def __post_init__(self):
        if self.mode not in ("exit", "raise"):
            raise ValueError(f"FaultPlan.mode must be 'exit' or 'raise', "
                             f"got {self.mode!r}")


class FaultInjector:
    """Call :meth:`after_step` at every step boundary; the process dies
    when the planned step is reached.  Fires at most once."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.fired = False

    @classmethod
    def from_env(cls, env=None) -> Optional["FaultInjector"]:
        """Build from ``REPRO_FAULT_STEP`` (and optional
        ``REPRO_FAULT_MODE``); None when no fault is configured -- so a
        launcher can unconditionally write
        ``injector = FaultInjector.from_env()``."""
        env = os.environ if env is None else env
        raw = env.get(ENV_STEP, "")
        if not raw:
            return None
        step = int(raw)
        if step < 0:
            return None
        return cls(FaultPlan(step, mode=env.get(ENV_MODE, "exit")))

    def after_step(self, step: int):
        """Die iff ``step`` has reached the plan.  ``mode="exit"``
        flushes stdout/stderr first (the run's printed losses are test
        evidence) but nothing else -- background threads are abandoned
        mid-flight, like a real preemption."""
        if self.fired or step < self.plan.kill_at_step:
            return
        self.fired = True
        if self.plan.mode == "raise":
            raise SimulatedFault(
                f"injected fault at step {step} "
                f"(planned: {self.plan.kill_at_step})")
        print(f"FAULT: killing at step {step}", flush=True)
        sys.stderr.flush()
        os._exit(self.plan.exit_code)
