"""The worlds of 4 gloo ranks on the CPU for the port's mesh test modules
(tests/test_torch_sharded_backends.py, tests/test_torch_serve_mesh.py and
tests/test_torch_train_mesh.py): each module gives a job, a JAX-free rank
function and its arguments (``world_args``), and ``world`` runs the jobs in
GROUPS, one spawned world a group, the worlds at once
(``repro_torch.parallel.collectives.run_world``; each rank runs its
group's jobs in turn, each on its own 2 x 2 mesh), and returns {job: the
ranks' results}.

It runs once per test session: a process keeps its results, and pytest-
xdist workers share them through the session's common temporary
directory, where the first worker to ask takes a file lock, runs the world
and pickles the results, and the others wait on the lock and read them:
under xdist's load distribution the tests of one module run in several
workers, and a world a module would be spawned in each of them.
"""
import os
import pickle
from concurrent.futures import ThreadPoolExecutor

import filelock

import _torch_mesh_ranks as R
from repro_torch.parallel.collectives import run_world

WORLD = 4
TIMEOUT_S = 900
# jobs of about equal length together: two worlds of 4 single-threaded
# ranks fill 8 cores
GROUPS = (("backends", "serve"), ("train",))
_RESULTS: dict = {}


def root(tmp_path_factory):
    """The session's directory of the world: shared by the xdist workers
    (their base temporary directories' parent), else the base one."""
    base = tmp_path_factory.getbasetemp()
    shared = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    out = shared / "torch_mesh_world"
    out.mkdir(exist_ok=True)
    return out


def _jobs(where) -> dict:
    import test_torch_serve_mesh as SM
    import test_torch_sharded_backends as SB
    import test_torch_train_mesh as TM
    return {"backends": ("_torch_mesh_ranks", "backends_rank",
                         SB.world_args()),
            "serve": ("_torch_mesh_ranks", "serve_rank", SM.world_args()),
            "train": ("_torch_train_ranks", "train_rank",
                      TM.world_args(where))}


def world(tmp_path_factory) -> dict:
    """{job: [rank 0's result, ..., rank 3's]} of every job."""
    if not _RESULTS:
        where = root(tmp_path_factory)
        done = where / "results.pkl"
        with filelock.FileLock(str(where / "lock"),
                               timeout=TIMEOUT_S + 300):
            if not done.exists():
                jobs = _jobs(where)
                with ThreadPoolExecutor(len(GROUPS)) as pool:
                    runs = [pool.submit(
                        run_world, R.world_rank, WORLD,
                        ({name: jobs[name] for name in group},),
                        init_method=f"file://{where}/rendezvous{i}",
                        timeout_s=TIMEOUT_S)
                        for i, group in enumerate(GROUPS)]
                    out = {name: [r[name] for r in run.result()]
                           for group, run in zip(GROUPS, runs)
                           for name in group}
                part = where / "results.tmp"
                part.write_bytes(pickle.dumps(out))
                os.replace(part, done)
        _RESULTS.update(pickle.loads(done.read_bytes()))
    return _RESULTS
