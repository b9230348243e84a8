"""Multi-rank worlds on one host, shared by the launchers (port of
``repro.launch.hostdev``).

The reference emulates a fleet of devices in ONE process by forcing XLA's
host-device count before jax initializes.  torch has no such thing: a
mesh is a world of processes (``repro_torch.launch.mesh``).  So on a host
without a launched world a debug mesh is R gloo *processes*: the same flag
scan as the reference (``--mesh`` in both spellings, the count from
``REPRO_SWEEP_DEVICES``, default 4) decides R, and :func:`spawn_ranks`
starts R ranks of the caller's entry point with ``RANK`` /
``WORLD_SIZE`` / ``LOCAL_RANK``, a ``file://`` rendezvous in a fresh
temporary directory (so concurrent test processes never fight over a
port) and one torch thread a rank.  Under ``torchrun`` (or in a spawned
rank) the environment already holds the world, and nothing is spawned.

This module imports no torch: a launcher can scan its flags before
anything else.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence


def in_world() -> bool:
    """Whether this process is a rank of a launched world (``torchrun``
    or :func:`spawn_ranks`)."""
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


def flag_value(argv: Sequence[str], flag: str) -> Optional[str]:
    """The last value of ``flag`` in ``argv`` (``--flag value`` or
    ``--flag=value``), or ``None``."""
    val = None
    for i, arg in enumerate(argv):
        if arg == flag and i + 1 < len(argv):
            val = argv[i + 1]
        elif arg.startswith(flag + "="):
            val = arg.split("=", 1)[1]
    return val


def requested_ranks(argv: Sequence[str], flag: str = "--mesh", *,
                    skip: Sequence[str] = ("none", "prod"),
                    env: str = "REPRO_SWEEP_DEVICES",
                    default: str = "4") -> Optional[int]:
    """The ranks ``argv`` asks for: ``None`` when ``flag`` is absent or
    its value in ``skip``, else the count from the ``env`` variable
    (default ``default``).  ``--mesh prod`` takes the launched world, so
    it is skipped here."""
    val = flag_value(argv, flag)
    if val is None or val in skip:
        return None
    return int(os.environ.get(env, default))


def spawn_ranks(n: int, cmd: Sequence[str], *,
                env: Optional[Dict[str, str]] = None,
                timeout: Optional[float] = None,
                capture: bool = False,
                cwd: Optional[str] = None) -> List[subprocess.CompletedProcess]:
    """Run ``cmd`` as ranks 0 .. n - 1 of one world and wait for all.

    Each rank gets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``LOCAL_WORLD_SIZE``, ``REPRO_DIST_INIT`` (a ``file://`` rendezvous in
    a temporary directory, removed after) and ``OMP_NUM_THREADS=1``, on
    top of ``env`` (default: this process's environment).  When a rank
    fails, the others are stopped, so a world never waits forever on a
    dead peer; at ``timeout`` seconds every rank is stopped.  Returns each
    rank's ``CompletedProcess`` (``stdout`` / ``stderr`` text with
    ``capture``; the returncode of a stopped rank is negative)."""
    base = dict(os.environ if env is None else env)
    rdzv = tempfile.mkdtemp(prefix="repro_torch_world_")
    procs, files = [], []
    try:
        for rank in range(n):
            e = dict(base, RANK=str(rank), WORLD_SIZE=str(n),
                     LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(n),
                     REPRO_DIST_INIT="file://" + os.path.join(rdzv, "rdzv"),
                     OMP_NUM_THREADS="1")
            # files, not pipes: a rank that writes a lot never blocks
            out = err = None
            if capture:
                out = open(os.path.join(rdzv, f"{rank}.out"), "w+")
                err = open(os.path.join(rdzv, f"{rank}.err"), "w+")
                files.append((out, err))
            procs.append(subprocess.Popen(list(cmd), env=e, cwd=cwd,
                                          stdout=out, stderr=err, text=True))
        deadline = None if timeout is None else time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or (
                    deadline is not None and time.monotonic() > deadline):
                _stop(procs)
            time.sleep(0.05)
        results = []
        for rank, p in enumerate(procs):
            texts = (None, None)
            if capture:
                texts = tuple(_read(f) for f in files[rank])
            results.append(subprocess.CompletedProcess(
                list(cmd), p.returncode, *texts))
        return results
    finally:
        _stop(procs)
        for pair in files:
            for f in pair:
                f.close()
        shutil.rmtree(rdzv, ignore_errors=True)


def _read(f) -> str:
    f.seek(0)
    return f.read()


def _stop(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()


def world_returncode(results: Sequence[subprocess.CompletedProcess]) -> int:
    """0 when every rank exited 0, else the first failing rank's code (1
    for a rank that was stopped)."""
    for r in results:
        if r.returncode != 0:
            return r.returncode if r.returncode > 0 else 1
    return 0


def force_host_devices(flag: str = "--mesh", *,
                       argv: Optional[Sequence[str]] = None,
                       module: Optional[str] = None,
                       skip: Sequence[str] = ("none", "prod"),
                       env: str = "REPRO_SWEEP_DEVICES",
                       default: str = "4") -> Optional[int]:
    """The reference's ``force_host_devices``, for processes: when
    ``argv`` (default ``sys.argv[1:]``) asks for a debug mesh
    (:func:`requested_ranks`) and this process is no rank of a world,
    spawn that many ranks of ``python -m module argv`` (``module``
    default: the running ``__main__``'s) and return the world's exit code
    (:func:`world_returncode`).  ``None``: run in this process (no mesh
    asked for, or already a rank)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if in_world():
        return None
    n = requested_ranks(argv, flag, skip=skip, env=env, default=default)
    if n is None:
        return None
    if module is None:
        spec = getattr(sys.modules["__main__"], "__spec__", None)
        if spec is None:
            raise RuntimeError("force_host_devices: name the entry point's "
                               "module (module=...)")
        module = spec.name
    print(f"spawning a world of {n} ranks: python -m {module}", flush=True)
    return world_returncode(spawn_ranks(n, [sys.executable, "-m", module,
                                            *argv]))
