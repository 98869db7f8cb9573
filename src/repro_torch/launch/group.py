"""Start a tensor-parallel group as one process per rank.

The counterpart, for processes, of the reference's ``make_host_mesh``
(``repro.launch.mesh``): :func:`spawn` starts ``size`` processes with
``torch.multiprocessing``'s ``spawn`` start method, builds a
:class:`~repro_torch.parallel.group.RankGroup` in each on a free port of
this host, makes it the active group, and calls ``fn(group, *args)``.
Each rank's value comes back pickled, in rank order.

There is no partial result: if a rank raises, dies or outlives the
timeout, every other rank is killed and :func:`spawn` raises with that
rank's traceback.  ``fn`` must be importable by name from a module the
ranks can import (a fresh interpreter imports it again), and its args
and value must pickle.
"""

from __future__ import annotations

import pickle
import queue as queue_mod
import socket
import time
import traceback

import torch
import torch.multiprocessing as mp

ADDR = "127.0.0.1"


def free_port(addr: str = ADDR) -> int:
    """A port that was free a moment ago (bound to port 0, then closed)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind((addr, 0))
        return s.getsockname()[1]


def _rank_main(fn, rank: int, size: int, device, port: int, inbox,
               results) -> None:
    """One rank's process: its group, ``fn`` on the args from ``inbox``,
    and its pickled value (or traceback) on ``results``."""
    from repro_torch.parallel.group import RankGroup
    from repro_torch.parallel.sharding import tp_group

    try:
        if torch.device(device).type == "cpu":
            torch.set_num_threads(1)
        args = pickle.loads(inbox.get())
        group = RankGroup(rank, size, addr=ADDR, port=port, device=device)
        with tp_group(group):
            value = fn(group, *args)
        group.close()
        results.put((rank, True, pickle.dumps(value)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


def spawn(fn, size: int, *, device, args=(), timeout: float = 300.0):
    """``[fn(group_r, *args) for r in range(size)]``, rank r in a process
    of its own.

    ``device`` is one device for every rank (``"cpu"``, or ``"cuda:0"``
    for ranks that share a card) or a sequence of ``size`` devices.  Raises
    ``RuntimeError`` with the traceback of the first rank that fails, or
    ``TimeoutError`` when the ranks are not done within ``timeout``
    seconds; either way no rank is left running.
    """
    if size < 1:
        raise ValueError(f"a group of {size} ranks")
    if isinstance(device, (str, torch.device)):
        devices = [str(device)] * size
    else:
        devices = [str(d) for d in device]
        if len(devices) != size:
            raise ValueError(f"{len(devices)} devices for {size} ranks")
    ctx = mp.get_context("spawn")
    inbox, results = ctx.Queue(), ctx.Queue()
    port = free_port()
    procs = [
        ctx.Process(target=_rank_main, daemon=True,
                    args=(fn, r, size, devices[r], port, inbox, results))
        for r in range(size)
    ]
    for p in procs:
        p.start()
    # The args go by queue, not with the process: a child reads its start
    # data while it imports, and a large payload there would make the
    # next start wait for that import.
    payload = pickle.dumps(tuple(args))
    for _ in procs:
        inbox.put(payload)
    values: dict[int, object] = {}
    failure = None
    deadline = time.monotonic() + timeout
    try:
        while len(values) < size and failure is None:
            try:
                rank, ok, body = results.get(timeout=0.2)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in values and p.exitcode not in (None, 0)]
                if dead:
                    failure = RuntimeError(
                        f"rank {dead[0]} of {size} died with exit code "
                        f"{procs[dead[0]].exitcode} and no traceback")
                elif time.monotonic() > deadline:
                    waiting = sorted(set(range(size)) - set(values))
                    failure = TimeoutError(
                        f"the group of {size} ranks was not done within "
                        f"{timeout} s; ranks {waiting} had not returned")
                continue
            if ok:
                values[rank] = pickle.loads(body)
            else:
                failure = RuntimeError(
                    f"rank {rank} of {size} raised:\n{body}")
    finally:
        if failure is not None or len(values) < size:
            for p in procs:
                if p.is_alive():
                    p.kill()
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():  # a kill that did not take: say so
                failure = failure or RuntimeError(
                    f"rank process {p.pid} outlived its kill")
    if failure is not None:
        raise failure
    return [values[r] for r in range(size)]


__all__ = ["ADDR", "free_port", "spawn"]
