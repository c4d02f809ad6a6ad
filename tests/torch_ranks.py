"""Run a snippet as the ranks of one gloo group on the CPU.

Each rank is a fresh ``python -c`` process (no xdist worker and no
pickled test function takes part), rendezvousing through a ``file://``
store under the test's ``tmp_path`` -- never a fixed TCP port, since
several test workers run at once.  A mismatched collective hangs gloo
for ever, so every rank is killed at the timeout and the test fails.
"""
import json
import os
import signal
import subprocess
import sys
import textwrap
import time
import uuid

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PRELUDE = """
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
RANK, WORLD = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
dist.init_process_group("gloo", init_method=os.environ["INIT_METHOD"],
                        rank=RANK, world_size=WORLD)
"""

# After a clean run, a rank that met through a file:// store sometimes
# aborts in C++ teardown at interpreter exit ("terminate called without
# an active exception", no Python frame; ~1 run in 4 of 8 ranks under
# load, never with os._exit): the rank's work is done and printed, so
# it leaves without running those destructors.
EPILOGUE = """
dist.barrier()
dist.destroy_process_group()
sys.stdout.flush()
sys.stderr.flush()
os._exit(0)
"""


def _kill(procs):
    for p in procs:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
    for p in procs:
        p.wait()


def run_ranks(code, world, tmp_path, *, timeout=120, expect_rc=0, env=None):
    """Run PRELUDE + ``code`` + EPILOGUE as ranks 0..world-1 and return
    each rank's result: the JSON object its code printed on the last
    line of its standard output (``None`` for a rank that printed
    none).  Raises AssertionError, with the ranks' output, if any rank
    exits with another code than ``expect_rc`` or the ranks outlast
    ``timeout`` seconds.  Ranks expected to die (``expect_rc`` not 0)
    return their whole standard output instead.  ``env`` adds to the
    ranks' environment."""
    run = tmp_path / f"ranks-{uuid.uuid4().hex[:8]}"
    run.mkdir()
    src = PRELUDE + textwrap.dedent(code) + EPILOGUE
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1", WORLD_SIZE=str(world),
               INIT_METHOD=f"file://{run / 'store'}", **(env or {}))
    procs, logs = [], []
    try:
        for r in range(world):
            out = open(run / f"rank{r}.out", "w+")
            err = open(run / f"rank{r}.err", "w+")
            logs.append((out, err))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", src], cwd=ROOT,
                env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                stdout=out, stderr=err, start_new_session=True))
        deadline = time.monotonic() + timeout
        for p in procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                _kill(procs)
                raise AssertionError(
                    f"{world} ranks outlasted {timeout} s (a mismatched "
                    f"collective?):\n{_report(logs)}") from None
        if any(p.returncode != expect_rc for p in procs):
            raise AssertionError(
                f"rank exit codes {[p.returncode for p in procs]}, expected "
                f"{expect_rc}:\n{_report(logs)}")
        results = []
        for out, _ in logs:
            out.seek(0)
            text = out.read()
            lines = text.strip().splitlines()
            results.append(text if expect_rc else
                           json.loads(lines[-1]) if lines else None)
        return results
    finally:
        _kill(procs)
        for out, err in logs:
            out.close()
            err.close()


def _report(logs):
    parts = []
    for r, (out, err) in enumerate(logs):
        out.seek(0)
        err.seek(0)
        parts.append(f"--- rank {r} stdout:\n{out.read()[-2000:]}\n"
                     f"--- rank {r} stderr:\n{err.read()[-3000:]}")
    return "\n".join(parts)
