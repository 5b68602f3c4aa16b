"""The port's training loops held against the JAX drivers', CLI to CLI,
over several epochs on the CPU (``scripts/train_trajectory.py``).

A tiny recipe of each flagship (8 steps an epoch, 4 epochs, the whole
cosine schedule, Huber PDE loss, seed 42) is trained by the JAX CLI in a
fresh interpreter on one CPU device and one thread, and by the port's CLI
at one and at four torch threads (``THREADS``: each splits its sums
otherwise) from the JAX run's own initial state, on the same data and
the same batches. The four JAX runs (each recipe, in epochs and
one step an epoch) start together, before the port's runs.

Held exactly: both runs log the same epochs at the same steps and print
the same skipped-update and recovery counts; the port's epoch eval on the
JAX run's final parameters gives the ``eval/rel_l2`` that the JAX run
logged there, within ``EVAL_RTOL``.

Held within limits set from two readings (``PERF.md`` §6 "PR 19"; my
CPU runs). Below a limit, the sound departures: the runs part at float32
rounding events that either implementation meets (turb3d at Adam's
first update: step 1's loss 1.5e-7 apart, the eval after it 4.2e-5;
rb2d at a kink of the loss crossed after step 5), read with the port at
1, 2, 4 and 8 torch threads. Above it, port faults planted in a copy and
run through the same harness: the batch ``RandomState`` restarted each
epoch, the cosine schedule read one step late, Adam's second-moment bias
correction one count late. (``--inner_steps 1`` for 2 is no fault: it
only groups steps into a dispatch, and reads the same bits.)

- Every epoch's ``train/loss`` and ``eval/rel_l2`` within
  ``EPOCH_LIMIT`` of JAX's: sound at most 1.61e-3 (turb3d) and 6.57e-3
  (rb2d); the restarted batches 1.80e-2 and 2.64e-2. The two optimizer
  faults stay inside the tiny recipe's spread at this grain.
- One step an epoch over the first epoch's batches: every step within
  ``PER_STEP_LIMIT`` (sound at most 5.52e-5 and 1.24e-4; each fault
  2.08e-3 or more on turb3d, 3.66e-2 or more on rb2d), and the steps
  before the runs part (``EARLY_STEPS``) within ``EARLY_LIMIT`` (sound
  at most 7.1e-7; on rb2d each fault 4.8e-3 or more; on turb3d step 1's
  loss, read before any update, holds the initial state, the first batch
  and the loss, which no planted fault moves).

``train/grad_norm`` is printed, not held.
"""

import importlib.util
import math
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVAL_RTOL = 1e-4
EPOCH_LIMIT = {"turb3d": 5e-3, "rb2d": 1.5e-2}
PER_STEP_LIMIT = {"turb3d": 2.5e-4, "rb2d": 1e-3}
EARLY_LIMIT = 1e-5
# One step an epoch: (steps whose train/loss, steps whose eval/rel_l2
# are held within EARLY_LIMIT). A step's loss is read before its
# update, its eval after it.
EARLY_STEPS = {"turb3d": (1, 0), "rb2d": (4, 4)}
THREADS = (1, 4)
CASES = [(r, per_step) for per_step in (False, True)
         for r in ("turb3d", "rb2d")]


def _trajectory():
    spec = importlib.util.spec_from_file_location(
        "train_trajectory", os.path.join(ROOT, "scripts",
                                         "train_trajectory.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def traj():
    return _trajectory()


@pytest.fixture(scope="module")
def jax_runs(traj, tmp_path_factory):
    """Every case's JAX CLI, started together."""
    handles = {}
    try:
        for recipe, per_step in CASES:
            work = tmp_path_factory.mktemp(
                recipe + ("_per_step" if per_step else ""))
            handles[recipe, per_step] = traj.start(recipe, str(work),
                                                   per_step)
        yield handles
    finally:
        for h in handles.values():
            traj.stop(h)


def _departures(traj, runs, steps):
    """Hold the exact checks of every port run: [its departures from
    JAX's run, an epoch each]."""
    assert [e["step"] for e in runs["jax"]] == steps
    assert runs["jax_counts"] == (0, 0)
    for e in runs["jax"]:
        assert all(math.isfinite(e[k]) for k in traj.KEYS), e
    step, got, logged = runs["eval_on_jax_params"]
    assert step == steps[-1]
    assert got == pytest.approx(logged, rel=EVAL_RTOL, abs=0)
    out = []
    for n, port in runs["port"].items():
        assert [e["step"] for e in port] == steps, n
        assert runs["port_result"][n]["start_epoch"] == 0
        assert runs["port_counts"][n] == runs["jax_counts"], n
        for e in port:
            assert all(math.isfinite(e[k]) for k in traj.KEYS), (n, e)
        out.append(traj.departures(runs["jax"], port))
    return out


@pytest.mark.parametrize("recipe", ["turb3d", "rb2d"])
def test_loop_matches_the_jax_cli_epoch_by_epoch(recipe, traj, jax_runs):
    runs = traj.finish(jax_runs[recipe, False], THREADS)
    print(traj.table(recipe, runs))
    steps = [traj.STEPS_PER_EPOCH * (i + 1) for i in range(traj.EPOCHS)]
    for n, ds in zip(THREADS, _departures(traj, runs, steps)):
        for epoch, d in enumerate(ds):
            for k in ("train/loss", "eval/rel_l2"):
                assert d[k] <= EPOCH_LIMIT[recipe], (n, epoch, k, d[k])


@pytest.mark.parametrize("recipe", ["turb3d", "rb2d"])
def test_loop_matches_the_jax_cli_step_by_step(recipe, traj, jax_runs):
    runs = traj.finish(jax_runs[recipe, True], THREADS)
    print(traj.table(recipe, runs))
    steps = list(range(1, traj.STEPS_PER_EPOCH + 1))
    early = dict(zip(("train/loss", "eval/rel_l2"), EARLY_STEPS[recipe]))
    for n, ds in zip(THREADS, _departures(traj, runs, steps)):
        for i, d in enumerate(ds):
            for k, held in early.items():
                limit = EARLY_LIMIT if i < held else PER_STEP_LIMIT[recipe]
                assert d[k] <= limit, (n, steps[i], k, d[k])
