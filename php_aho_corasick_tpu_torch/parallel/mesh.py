"""The data mesh: packed corpus rows split over shards, one device each.

Counterpart of the JAX package's ``parallel/mesh.py``.  A
:class:`DataMesh` is an ordered list of ``torch.device`` objects, one per
shard of this process; a device may repeat, so several shards can share
one card (the counterpart of ``--xla_force_host_platform_device_count``,
which the JAX package's CPU tests use for a mesh of 8 virtual devices).
Rows are split into contiguous blocks, shard ``s`` holding block ``s``
(:func:`row_sharding`); the automaton's arrays are held once per distinct
device (:func:`replicated`), however many shards share it.

Across processes (:func:`init_distributed`), every process holds the same
number of shards, and the mesh spans them all: shard ids
``rank * n_local .. rank * n_local + n_local - 1`` are this process's.
Each process packs the same documents and keeps the row blocks of its own
shards; the sharded scans then gather counts and buffers with
``torch.distributed.all_reduce`` (``parallel/shard_scan.py``).
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

#: shards of one device on a mesh built with no device list (None: one
#: shard per visible device); set through :func:`local_shards`
_LOCAL_SHARDS: Optional[int] = None


def _require_cuda(devices: Sequence[torch.device]) -> None:
    """Raise when a CUDA device is asked for and none is available: a
    sharded scan never carries on on the CPU instead."""
    if any(d.type == "cuda" for d in devices) and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available for a CUDA mesh; build the matcher "
            "with device='cpu' to shard on the CPU"
        )


class DataMesh:
    """The shards of this process, in order: ``devices[i]`` runs global
    shard ``first_shard + i`` of ``n_shards``."""

    def __init__(self, devices: Sequence, n_shards: Optional[int] = None,
                 first_shard: int = 0) -> None:
        if not devices:
            raise ValueError("a data mesh needs at least one device")
        self.devices: List[torch.device] = [torch.device(d) for d in devices]
        _require_cuda(self.devices)
        self.n_shards = len(self.devices) if n_shards is None else n_shards
        self.first_shard = first_shard

    @property
    def n_local(self) -> int:
        return len(self.devices)

    @property
    def shard_ids(self) -> range:
        return range(self.first_shard, self.first_shard + self.n_local)

    @property
    def home(self) -> torch.device:
        """The device that holds the gathered counts and buffers."""
        return self.devices[0]

    def __len__(self) -> int:
        return self.n_shards

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (
            f"DataMesh({self.n_shards} shards, local "
            f"{list(self.shard_ids)} on {[str(d) for d in self.devices]})"
        )


def process_count() -> int:
    """Processes of the initialised ``torch.distributed`` group (1 when
    there is none): the counterpart of ``jax.process_count()``."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """Join this process to a ``torch.distributed`` group of
    ``num_processes``, rank ``process_id``, through the TCP store at
    ``coordinator_address`` (``host:port``).  A no-op with no arguments.
    ``backend=None`` takes NCCL where CUDA is available, else gloo;
    processes that share one card pass ``"gloo"`` (NCCL cannot pair two
    ranks on one device)."""
    if coordinator_address is None and num_processes is None:
        return
    import torch.distributed as dist

    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    url = coordinator_address
    if "://" not in url:
        url = f"tcp://{url}"
    dist.init_process_group(
        backend, init_method=url, world_size=num_processes, rank=process_id
    )


@contextlib.contextmanager
def local_shards(n: Optional[int]) -> Iterator[None]:
    """Within the block, a mesh built without a device list holds ``n``
    shards of the matcher's device (``None``: the default, one shard per
    visible device).  The port's counterpart of
    ``--xla_force_host_platform_device_count``."""
    global _LOCAL_SHARDS
    prev, _LOCAL_SHARDS = _LOCAL_SHARDS, n
    try:
        yield
    finally:
        _LOCAL_SHARDS = prev


def data_mesh(devices: Optional[Sequence] = None, device=None) -> DataMesh:
    """The mesh over ``devices`` (this process's shards), or by default:
    ``n`` shards of ``device`` inside :func:`local_shards`, else every
    visible CUDA device for a CUDA ``device`` (the default; ``device``
    first) and the CPU as one device for a CPU one.  Across processes the
    mesh spans every process's shards."""
    if devices is None:
        dev = torch.device("cuda" if device is None else device)
        _require_cuda([dev])
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if _LOCAL_SHARDS is not None:
            devices = [dev] * _LOCAL_SHARDS
        elif dev.type == "cuda":
            # the matcher's card first: it holds the gathered results
            devices = [dev] + [
                torch.device("cuda", i)
                for i in range(torch.cuda.device_count()) if i != dev.index
            ]
        else:
            devices = [dev]
    n_local = len(devices)
    world = process_count()
    if world == 1:
        return DataMesh(devices)
    import torch.distributed as dist

    return DataMesh(devices, n_local * world, dist.get_rank() * n_local)


def row_sharding(mesh: DataMesh, x, pin: bool = False) -> List[torch.Tensor]:
    """This process's row blocks of ``x`` (``[B, ...]`` numpy array or
    tensor, ``B`` a multiple of the shard count): block ``s`` of ``B /
    n_shards`` contiguous rows on ``mesh.devices[s - first_shard]``.
    ``pin`` stages host blocks in pinned memory so their copies to a card
    do not wait."""
    B = x.shape[0]
    if B % mesh.n_shards:
        raise ValueError(
            f"{B} rows do not split evenly over {mesh.n_shards} shards"
        )
    per = B // mesh.n_shards
    out = []
    for s, dev in zip(mesh.shard_ids, mesh.devices):
        part = x[s * per : (s + 1) * per]
        if isinstance(part, np.ndarray):
            part = torch.from_numpy(np.ascontiguousarray(part))
            if pin and dev.type == "cuda":
                part = part.pin_memory()
        out.append(part.to(dev, non_blocking=True))
    return out


def replicated(mesh: DataMesh, arrays: dict) -> List[dict]:
    """One dict of ``arrays`` per shard, on that shard's device: held once
    per distinct device (shards of one device share the dict, and arrays
    already on a device are not copied)."""
    by_dev = {}
    out = []
    for dev in mesh.devices:
        rep = by_dev.get(dev)
        if rep is None:
            rep = by_dev[dev] = {k: v.to(dev) for k, v in arrays.items()}
        out.append(rep)
    return out
