# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""The launchers' ``torch.distributed`` world: the flags that name it, its
initialisation, and a spawn of every rank of a launcher from one command.

    python -m repro_torch.launch.serve_glm --smoke --mesh 2x4 --backend gloo \
        --device cpu --spawn 8
    torchrun --nproc-per-node 4 -m repro_torch.launch.chaos_glm --smoke \
        --mesh 2x2 --backend nccl

A launcher given ``--backend`` runs as one rank of a world:
:func:`init_world` initialises it from ``--init-method`` / ``--world-size``
/ ``--rank`` when they are given (the ranks that ``--spawn N`` starts get
them), else from torchrun's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``). Under NCCL each rank
takes the card of its ``LOCAL_RANK``. A launcher runs its rank's work
inside :func:`world_scope` (``launch.mesh``), which ends the world with
a barrier and ``destroy_process_group`` (without the barrier when the
rank raises), so that no rank exits with a live process group (its
threads would abort the process at exit).
:func:`spawn_world` starts the N
ranks as subprocesses of this Python with a ``file://`` store in a
temporary directory (no TCP port), waits for them under a deadline, and
kills and reaps every one of them whatever happens.
"""
from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
from typing import List, Optional, Sequence

import torch

from repro_torch.launch.mesh import DEFAULT_TIMEOUT

#: seconds a spawned world may run before its ranks are killed
SPAWN_DEADLINE_S = 900


def add_world_args(ap) -> None:
    """The world flags, shared by the launchers."""
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"),
                    help="run as one rank of a torch.distributed world with this backend "
                         "(a DxM / PxDxM --mesh then spans its ranks)")
    ap.add_argument("--init-method", default=None,
                    help="the world's rendezvous (e.g. file:///tmp/store); default: "
                         "torchrun's environment")
    ap.add_argument("--world-size", type=int, default=None)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--spawn", type=int, default=None, metavar="N",
                    help="start N ranks of this launcher (with --backend), wait for them "
                         "under a deadline and exit with the first failing rank's code")


def init_world(args, timeout: timedelta = DEFAULT_TIMEOUT) -> Optional[torch.device]:
    """Initialise the world ``args`` name (no-op without ``--backend`` or
    when one is initialised). Returns the rank's card under NCCL, else
    None."""
    import torch.distributed as dist

    if args.backend is None or dist.is_initialized():
        return None
    if args.init_method is not None:
        if args.world_size is None or args.rank is None:
            raise SystemExit("--init-method needs --world-size and --rank")
        rank, world, local = args.rank, args.world_size, args.rank
        init = args.init_method
    else:
        try:
            rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
            local = int(os.environ.get("LOCAL_RANK", rank))
        except KeyError as e:
            raise SystemExit(f"--backend without --init-method runs under torchrun: {e} "
                             f"is not set") from None
        init = "env://"
    card = None
    if args.backend == "nccl":
        card = torch.device("cuda", local)
        torch.cuda.set_device(card)
    dist.init_process_group(args.backend, init_method=init, world_size=world, rank=rank,
                            timeout=timeout)
    return card


def is_rank_zero() -> bool:
    """Whether this process is rank 0 of its world (or in none)."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def _strip(argv: Sequence[str], flag: str) -> List[str]:
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
        elif a == flag:
            skip = True
        elif not a.startswith(flag + "="):
            out.append(a)
    return out


def spawn_world(module: str, argv: Sequence[str], world: int,
                deadline_s: float = SPAWN_DEADLINE_S) -> int:
    """Run ``python -m module argv`` as ``world`` ranks (``--spawn``
    dropped, ``--init-method`` / ``--world-size`` / ``--rank`` added), each
    rank's output prefixed with its number. Returns 0, or the first failing
    rank's exit code (124 past the deadline, every rank killed)."""
    base = _strip(argv, "--spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs, codes = [], []
        try:
            for r in range(world):
                cmd = [sys.executable, "-m", module, *base,
                       "--init-method", f"file://{tmp}/store", "--world-size", str(world),
                       "--rank", str(r)]
                with open(os.path.join(tmp, f"rank{r}.log"), "w") as log:
                    procs.append(subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT))
            end = time.monotonic() + deadline_s
            for proc in procs:
                try:
                    # allow[torch-bench-timing]: a deadline on child processes, not a timing of CUDA work
                    codes.append(proc.wait(timeout=max(end - time.monotonic(), 0.1)))
                except subprocess.TimeoutExpired:
                    codes.append(124)
                    break
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                proc.wait()
        for r in range(len(procs)):
            with open(os.path.join(tmp, f"rank{r}.log")) as log:
                for line in log.read().splitlines():
                    print(f"[rank {r}] {line}")
    return next((c for c in codes if c), 0)


def mesh_from_args(args, device):
    """The launcher's mesh: None for ``--mesh local``, else
    ``launch.mesh.parse_mesh`` of the spec, over the world of
    :func:`init_world` when ``--backend`` is given (a :class:`ProcMesh`
    on the rank's card under NCCL, on ``device`` under gloo), else a (1, M)
    ``DevMesh`` on ``device``."""
    from repro_torch.launch.mesh import parse_mesh

    card = init_world(args)
    if args.mesh == "local":
        return None
    return parse_mesh(args.mesh, backend=args.backend,
                      device=device if card is None else card)
