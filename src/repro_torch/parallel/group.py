"""A tensor-parallel group whose ranks are processes (ROADMAP A9).

The reference runs every schedule per device inside ``shard_map``; the
port's :class:`~repro_torch.parallel.sharding.TPGroup` stacks its ranks
on one device in one process.  A :class:`RankGroup` is one rank of a
group of ``size`` processes, each holding only its own blocks, as a
``shard_map`` body does.  It is built from an explicit rank, size,
address and port (:mod:`repro_torch.launch.group` starts the processes)
and made active with :func:`~repro_torch.parallel.sharding.tp_group`, so
``active_group()`` returns either kind; code that needs one kind checks
for it.

Two kinds of traffic cross its processes:

  * **control**: a gloo process group for handle exchange and barriers,
    on the host whatever the devices;
  * **plain collectives** (:mod:`repro_torch.parallel.collectives` with
    ``group=``): gloo when the ranks are on the CPU, NCCL when each rank
    has a card of its own (:func:`plain_backend`).  The NCCL group is made
    when the group is, on every rank in the same order (``new_group`` is
    collective over the world), after every pair of the group's cards is
    found to reach the other's memory (:func:`check_peer_access`).  Ranks
    that share one card cannot run them: NCCL refuses two ranks on one
    device, and nothing falls back to gloo or the host, so the first
    plain collective raises (ROADMAP A9).

K3's and K4's exchanges cross processes through CUDA IPC instead
(``peers``, a :class:`~repro_torch.kernels.peer_memory.PeerMemory`):
device memory each rank exports once, mapped by its peers, whether the
peer is another card or another context on the same card.
"""

from __future__ import annotations

import datetime
import socket

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.kernels.peer_memory import PeerMemory
from repro_torch.parallel.sharding import CopyStreams

# How long a control-group call (handle exchange, barrier) waits for its
# peers; the launcher's own timeout bounds a whole run.
CONTROL_TIMEOUT = datetime.timedelta(seconds=300)

SHARED_CARD = (
    "the ranks of this group share a CUDA device ({devices}): its plain "
    "collectives run on NCCL between cards, and NCCL refuses two ranks on "
    "one device; they need a card per rank (ROADMAP A9).  K3's and K4's "
    "exchanges do run across processes on one card."
)


def plain_backend(devices, hosts=None) -> str:
    """The backend of a group's plain collectives, from its ranks' devices
    (and hosts, where several): ``"gloo"`` when every rank is on the CPU,
    ``"nccl"`` when each has a CUDA device of its own.  Ranks that share a
    CUDA device raise, citing ROADMAP A9; a group that mixes the CPU and
    CUDA raises too."""
    devices = [torch.device(d) for d in devices]
    kinds = {d.type for d in devices}
    if kinds == {"cpu"}:
        return "gloo"
    if kinds != {"cuda"}:
        raise ValueError(f"a group's ranks are all on the CPU or all on CUDA "
                         f"devices, not {[str(d) for d in devices]}")
    where = list(zip(hosts or [None] * len(devices), devices))
    if len(set(where)) < len(where):
        raise RuntimeError(SHARED_CARD.format(
            devices=", ".join(str(d) for d in devices)))
    return "nccl"


def check_peer_access(devices, hosts=None) -> None:
    """Raise, naming the pair, unless every two of the group's cards on
    one host reach each other's memory (``can_device_access_peer``): K3's
    pushes, K4's reads and NCCL's transfers go card to card, and nothing
    stages through the host."""
    where = list(zip(hosts or [None] * len(devices),
                     (torch.device(d) for d in devices)))
    for i, (host_a, a) in enumerate(where):
        for host_b, b in where[i + 1:]:
            if host_a != host_b or a == b:
                continue
            for src, dst in ((a, b), (b, a)):
                if not torch.cuda.can_device_access_peer(src.index,
                                                         dst.index):
                    raise RuntimeError(
                        f"{src} cannot access {dst}'s memory (no peer "
                        "access): a group with a card per rank exchanges "
                        "card to card and stages nothing through the host")


class RankGroup(CopyStreams):
    """Rank ``rank`` of a tensor-parallel group of ``size`` processes.

    Joins the group's gloo control group at ``tcp://addr:port`` (rank 0
    listens there), then gathers every rank's host and device; with a card
    per rank it checks their peer access and makes the NCCL group of the
    plain collectives (every rank at this point).  On CUDA it
    owns the copy streams of the chunk exchange, as
    :class:`~repro_torch.parallel.sharding.TPGroup` does
    (:class:`~repro_torch.parallel.sharding.CopyStreams`); ``peers`` is
    what K3 and K4 take to cross its processes.  :meth:`close` releases
    the exported memory and leaves the process group.
    """

    def __init__(self, rank: int, size: int, *, addr: str, port: int,
                 device=None):
        if size < 1 or not 0 <= rank < size:
            raise ValueError(f"rank {rank} of a group of {size}")
        self.rank, self.size = int(rank), int(size)
        dev = resolve_device(device)
        if dev.type == "cuda":
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            torch.cuda.set_device(dev)
        self.device = dev
        dist.init_process_group(
            "gloo", init_method=f"tcp://{addr}:{port}", rank=self.rank,
            world_size=self.size, timeout=CONTROL_TIMEOUT)
        self.control = dist.group.WORLD
        self.peers = PeerMemory(self.rank, self.size, dev, self.control)
        where = self.peers.gather_object((socket.gethostname(), str(dev)))
        self.hosts = tuple(h for h, _ in where)
        self.devices = tuple(torch.device(d) for _, d in where)
        try:
            backend = plain_backend(self.devices, self.hosts)
        except RuntimeError as err:  # ranks sharing a card: K3 and K4 run
            self._plain = err
        else:
            if backend == "nccl":
                check_peer_access(self.devices, self.hosts)
                self._plain = dist.new_group(backend="nccl")
            else:
                self._plain = self.control

    def barrier(self) -> None:
        dist.barrier(group=self.control)

    @property
    def plain(self):
        """The process group the plain collectives run on (the control
        group on the CPU; the NCCL group across cards); raises where the
        ranks share a card."""
        if isinstance(self._plain, RuntimeError):
            raise RuntimeError(str(self._plain))
        return self._plain

    def close(self) -> None:
        """Release the exported memory (:meth:`PeerMemory.close
        <repro_torch.kernels.peer_memory.PeerMemory.close>`), then leave
        the process group."""
        self.peers.close()
        dist.destroy_process_group()

    def __repr__(self) -> str:
        return (f"RankGroup(rank={self.rank}, size={self.size}, "
                f"device={str(self.device)!r})")


__all__ = ["SHARED_CARD", "CONTROL_TIMEOUT", "plain_backend",
           "check_peer_access", "RankGroup"]
