"""Multi-host fleets (counterpart of aphantasia_tpu.parallel.multihost).

A fleet is a set of independent jobs that share a filesystem: illustra
renders its scenes round robin over the hosts, interpol its snapshot
pairs, and the other CLIs run their whole job on each host.  No hot-loop
collective crosses the fleet.  With a coordinator (`R/W@host:port`) and
W > 1, `init_fleet` starts a gloo group over a TCP store at that address,
in place of the JAX multi-process runtime; it serves coordination only
(`parallel/dcn.py` agrees its mesh's address and host sizes over it).
Without one, the coordinates are bookkeeping for the sharding alone.
"""
from __future__ import annotations

import os
import re
from typing import List, Optional, Tuple

_FLEET: Optional[Tuple[int, int]] = None  # (rank, world) after init_fleet
_COORD: Optional[str] = None              # the coordinator, if one was given


def parse_fleet(spec: str) -> Tuple[int, int, Optional[str]]:
    """'R/N' or 'R/N@host:port' -> (rank, world, coordinator|None)."""
    m = re.fullmatch(r"(\d+)/(\d+)(?:@(.+))?", spec.strip())
    if not m:
        raise ValueError(
            "fleet spec must be 'RANK/WORLD' or 'RANK/WORLD@HOST:PORT', "
            f"got {spec!r}")
    rank, world = int(m.group(1)), int(m.group(2))
    if world < 1 or not (0 <= rank < world):
        raise ValueError(f"invalid fleet coordinates {rank}/{world}")
    return rank, world, m.group(3)


def _group_coords() -> Tuple[int, int]:
    """(rank, world) of an initialised default group of torch.distributed,
    else (0, 1)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def init_fleet(spec: Optional[str] = None) -> Tuple[int, int]:
    """Initialise the fleet coordinates (idempotent).  Resolution order:

    1. the spec, or the APHANTASIA_FLEET variable ('R/N[@host:port]'):
       with a coordinator and N > 1, a gloo group over a TCP store at
       that address; without one, rank and world for the sharding alone;
    2. an already-initialised default group of torch.distributed, whose
       rank and size are adopted;
    3. a single process (0/1).

    A coordinator-less spec that disagrees with an initialised group of
    more than one process yields to the group."""
    global _FLEET, _COORD
    if _FLEET is not None:
        return _FLEET
    spec = spec or os.environ.get("APHANTASIA_FLEET")
    if spec:
        rank, world, coordinator = parse_fleet(spec)
        if coordinator and world > 1:
            import torch.distributed as dist
            if not dist.is_initialized():
                dist.init_process_group(
                    "gloo", init_method=f"tcp://{coordinator}",
                    world_size=world, rank=rank)
            rank, world = dist.get_rank(), dist.get_world_size()
        else:
            pr, pw = _group_coords()
            if pw > 1 and (pr, pw) != (rank, world):
                print(f" fleet: spec {rank}/{world} disagrees with the "
                      f"initialised process group {pr}/{pw}; using the group")
                rank, world = pr, pw
        _FLEET, _COORD = (rank, world), coordinator
        return _FLEET
    pr, pw = _group_coords()
    _FLEET = (pr, pw) if pw > 1 else (0, 1)
    return _FLEET


def coordinator() -> Optional[str]:
    """The coordinator of the fleet spec, or None."""
    return _COORD


def fleet_info() -> Tuple[int, int]:
    """(rank, world); (0, 1) when init_fleet was never called."""
    return _FLEET if _FLEET is not None else (0, 1)


def is_primary() -> bool:
    return fleet_info()[0] == 0


def shard_scenes(count: int, rank: Optional[int] = None,
                 world: Optional[int] = None) -> List[int]:
    """Round-robin assignment of independent work units, so that every
    host gets early scenes and a partial fleet still leaves a watchable
    prefix of the piece."""
    if rank is None or world is None:
        rank, world = fleet_info()
    return list(range(rank, count, world))


def _adopt(fleet: Tuple[int, int], coord: Optional[str]) -> None:
    """Set the coordinates a launcher resolved (a mesh rank inherits its
    host's fleet and must not adopt the mesh's own group)."""
    global _FLEET, _COORD
    _FLEET, _COORD = tuple(fleet), coord


def _reset_for_tests():
    global _FLEET, _COORD
    _FLEET = _COORD = None
