"""Spawned gloo worlds end their process group before their ranks exit.

A rank that leaves with a live gloo group aborts at exit ("terminate
called without an active exception", exit code 134) when the group's
threads are torn down with the interpreter. ``launch.mesh.world_scope``
ends the world a block started: a barrier and ``destroy_process_group``
when the block returns, ``destroy_process_group`` alone when it raises.
The launchers run each rank inside it; here two worlds of two CPU ranks
are spawned through ``launch.world.spawn_world`` under one deadline, one
that serves and one whose ranks all raise, and a world of one is
initialised in the test process.

The abort at exit comes and goes with thread timing, so each spawned rank
runs ``serve_glm.main`` through a small wrapper module that registers an
``atexit`` hook first: it prints :data:`LEFT_OPEN` when the rank reaches
interpreter exit with its process group still initialised. The hook runs
before torch's own exit handlers (``atexit`` is last in, first out), so a
rank that skips ``world_scope`` prints it every time.
"""
import contextlib
import io
import os
import re
import time

import pytest
import torch.distributed as dist

from repro_torch.launch.mesh import world_scope
from repro_torch.launch.world import spawn_world

#: seconds both spawned worlds may take together (about 10 s each alone)
DEADLINE = 240
SERVE = ["--smoke", "--mesh", "1x2", "--backend", "gloo", "--device", "cpu", "--steps", "2",
         "--spawn", "2"]
#: printed by a rank that reaches interpreter exit with a live process group
LEFT_OPEN = "PROCESS GROUP LEFT OPEN AT EXIT"
#: the module each spawned rank runs: serve_glm's main behind the exit hook
RANK_MODULE = f"""
import atexit, sys
import torch.distributed as dist

def _left_open():
    if dist.is_available() and dist.is_initialized():
        print({LEFT_OPEN!r}, flush=True)

atexit.register(_left_open)
from repro_torch.launch import serve_glm
serve_glm.main(sys.argv[1:])
"""


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """(exit code, output) of a serving world and of a world whose ranks
    raise (a checkpoint that is not there), one after the other under
    one deadline."""
    tmp = tmp_path_factory.mktemp("world")
    (tmp / "serve_glm_rank.py").write_text(RANK_MODULE)
    saved = {k: os.environ.get(k) for k in ("OMP_NUM_THREADS", "PYTHONPATH")}
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(tmp), saved["PYTHONPATH"]) if p)
    end = time.monotonic() + DEADLINE
    out = {}
    try:
        for tag, extra in (("serve", []), ("raise", ["--load-path", str(tmp / "missing")])):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                code = spawn_world("serve_glm_rank", SERVE + extra, 2,
                                   deadline_s=max(end - time.monotonic(), 1.0))
            out[tag] = (code, buf.getvalue())
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    return out


def test_spawned_world_exits_zero_on_every_rank(spawned):
    code, log = spawned["serve"]
    assert code == 0, log[-3000:]
    assert "terminate called" not in log, log[-3000:]
    assert LEFT_OPEN not in log, log[-3000:]
    assert "[rank 0] SERVE SMOKE OK" in log


def test_spawned_ranks_that_raise_end_their_world(spawned):
    """Every rank raises on the missing checkpoint after the world is up:
    each leaves through ``world_scope``'s error path (no barrier), with
    its own error and exit code 1, not an abort at exit."""
    code, log = spawned["raise"]
    assert code == 1, log[-3000:]
    assert "terminate called" not in log, log[-3000:]
    assert LEFT_OPEN not in log, log[-3000:]
    for r in (0, 1):
        assert re.search(rf"^\[rank {r}\] .*CheckpointCorruption: missing manifest", log,
                         re.M), log[-3000:]


def _world_of_one(tmp_path, name):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/{name}", world_size=1,
                            rank=0)


def test_world_scope_ends_the_world_it_started(tmp_path):
    with world_scope():
        _world_of_one(tmp_path, "store_ok")
        assert dist.is_initialized()
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="inside"):
        with world_scope():
            _world_of_one(tmp_path, "store_raise")
            raise RuntimeError("inside the block")
    assert not dist.is_initialized()


def test_world_scope_leaves_an_outer_world_alone(tmp_path):
    _world_of_one(tmp_path, "store_outer")
    try:
        with world_scope():
            pass
        assert dist.is_initialized()
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()
