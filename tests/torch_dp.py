"""Helpers of the port's data-parallel CPU tests: spawn W gloo ranks of
``tests/torch_dp_worker.py`` and collect what they wrote.

Each rank is its own ``python`` process (the workers import no JAX), joined
through a ``file://`` rendezvous in the test's temporary directory, so tests
on parallel pytest workers never share a port. Every launch has a time
limit: past it the ranks are killed and the test fails. A test starts its
ranks before it computes its JAX oracle, so that the two overlap.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_dp_worker.py")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child_env(extra: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env.update({"OMP_NUM_THREADS": "1", "PYTHONPATH": REPO})
    env.update(extra or {})
    return env


def wait_all(procs: List[subprocess.Popen], timeout: float) -> List[int]:
    """Exit codes of ``procs``; kills every one still running after
    ``timeout`` seconds and raises."""
    end = time.monotonic() + timeout
    codes = []
    try:
        for p in procs:
            codes.append(p.wait(timeout=max(end - time.monotonic(), 0.1)))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
        raise AssertionError(f"ranks still running after {timeout} s: killed")
    return codes


def launcher_env(rank: int, world: int, rendezvous: str) -> Dict[str, str]:
    """What a launcher sets for one rank on one host, with the ``file://``
    rendezvous ``DIST_INIT_METHOD`` in place of ``MASTER_ADDR`` and
    ``MASTER_PORT`` (no TCP port that another test could take)."""
    return {"DIST_INIT_METHOD": "file://" + rendezvous, "WORLD_SIZE": str(world),
            "RANK": str(rank), "LOCAL_RANK": str(rank)}


def start_ranks(scenario: str, world: int, tmp_path, inputs, launcher: bool = False):
    """Start ``world`` ranks of ``scenario``: (scenario, processes, output
    directory). With ``launcher`` the ranks get :func:`launcher_env` and
    join the group themselves (the CLIs do)."""
    d = str(tmp_path)
    os.makedirs(d, exist_ok=True)
    store = os.path.join(d, "rendezvous")
    if os.path.exists(store):  # a stale store would hang
        os.remove(store)
    torch.save(inputs, os.path.join(d, "inputs.pt"))
    procs = []
    for r in range(world):
        with open(os.path.join(d, f"log_{r}.txt"), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, WORKER, scenario, str(r), str(world), d], stdout=log,
                stderr=subprocess.STDOUT,
                env=child_env(launcher_env(r, world, store) if launcher else None), cwd=REPO))
    return scenario, procs, d


def finish(launch, timeout: float = 90.0) -> List[dict]:
    """Each rank's output of a :func:`start_ranks` launch. A rank that fails
    fails the test with its output."""
    scenario, procs, d = launch
    codes = wait_all(procs, timeout)
    if any(codes):
        text = "\n".join(f"--- rank {r} (exit {c}) ---\n"
                         + open(os.path.join(d, f"log_{r}.txt")).read()[-3000:]
                         for r, c in enumerate(codes))
        raise AssertionError(f"{scenario} failed:\n{text}")
    return [torch.load(os.path.join(d, f"out_{r}.pt"), weights_only=False)
            for r in range(len(procs))]


def run_ranks(scenario: str, world: int, tmp_path, inputs, timeout: float = 90.0,
              launcher: bool = False) -> List[dict]:
    """Run ``scenario`` on ``world`` ranks with ``inputs``; returns each
    rank's output. Tests that also compute a JAX oracle start the ranks
    first (:func:`start_ranks`) and :func:`finish` after it."""
    return finish(start_ranks(scenario, world, tmp_path, inputs, launcher), timeout)


# the in-memory dataset of tests/test_torch_loop.py
def items(n_train_ids=4, per_id=4):
    """(train, query, gallery) item lists (``tests/test_torch_loop.py``'s)."""
    train = [(("train", i), i // per_id, i % 2, -1) for i in range(n_train_ids * per_id)]
    query = [(("query", i), 50 + i, 0, -1) for i in range(4)]
    gallery = [(("gallery", i), 50 + i % 4, i // 4, -1) for i in range(8)]
    return train, query, gallery


def decode(item, size=(64, 32)):
    """Per-identity uint8 prototype plus noise (``tests/test_torch_loop.py``'s)."""
    (kind, i), pid = item[0], item[1]
    proto = np.random.RandomState(1000 + pid).randint(0, 256, size + (3,))
    noise = np.random.RandomState(7 * i + len(kind)).randint(-25, 26, size + (3,))
    img = np.clip(proto + noise, 0, 255).astype(np.uint8)
    return [img, np.roll(img, 1, axis=0), np.roll(img, 2, axis=1)]
