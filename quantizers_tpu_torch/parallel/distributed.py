"""Multi-process bring-up: ``torch.distributed`` and node-aware meshes.

Counterpart of ``quantizers_tpu/parallel/distributed.py``. One process per
rank, each on one device: :func:`initialize` brings up the process group
from the launch's environment, and :func:`make_pod_mesh` lays the slow
axes (``dp`` by default) across nodes and the others (``tp``, ``ep``)
within a node, so that the per-token tensor-parallel collectives stay on a
node's own links.

Several cards of one node, one process each (NCCL)::

    torchrun --nproc-per-node 4 -m quantizers_tpu_torch.cli.serve <ckpt> --mesh tp=4

or without torchrun, on every rank ``i`` of ``n``::

    QTPU_COORDINATOR=host0:29500 QTPU_NUM_PROCESSES=n QTPU_PROCESS_ID=$i \\
        LOCAL_RANK=$i python -m quantizers_tpu_torch.cli.serve <ckpt> --mesh tp=n

Two ranks on one card (NCCL refuses two ranks on one device, so the ranks
take ``gloo``, whose CUDA collectives pass through host memory): the same
with ``LOCAL_RANK=0`` for both and ``QTPU_DIST_BACKEND=gloo``.

``tests/test_torch_distributed.py`` runs the CPU counterpart: four ``gloo``
processes as two simulated nodes (``LOCAL_WORLD_SIZE=2``), a ``dp`` x
``tp`` pod mesh and one sharded loss.
"""

from __future__ import annotations

import datetime
import logging
import os
import socket
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .._device import DeviceLike

logger = logging.getLogger(__name__)

#: seconds a collective (and the bring-up) waits for a lost rank
DEFAULT_TIMEOUT_S = 120.0

_DEVICE: Optional[torch.device] = None


def local_device() -> Optional[torch.device]:
    """This rank's device, as :func:`initialize` chose it (None before)."""
    return _DEVICE


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def _rank_device(local_device_ids: Optional[Sequence[int]], device: DeviceLike) -> torch.device:
    if device is not None:
        return torch.device(device)
    ids = list(local_device_ids) if local_device_ids is not None else None
    if ids is None and os.environ.get("LOCAL_RANK"):
        ids = [int(os.environ["LOCAL_RANK"])]
    if not ids:
        raise ValueError("initialize: name this rank's card (local_device_ids, or LOCAL_RANK in "
                         "the environment), or pass device='cpu' for a CPU rank")
    if not torch.cuda.is_available():
        raise RuntimeError("initialize: no CUDA device is available; pass device='cpu' to run "
                           "a CPU rank")
    return torch.device("cuda", int(ids[0]))


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids: Optional[Sequence[int]] = None,
               backend: Optional[str] = None,
               device: DeviceLike = None,
               timeout_s: Optional[float] = None) -> bool:
    """Bring up ``torch.distributed`` for a multi-process run.

    The arguments default to ``QTPU_COORDINATOR`` (``host:port``, or an
    ``init_method`` URL such as ``file:///path``), ``QTPU_NUM_PROCESSES`` and
    ``QTPU_PROCESS_ID``, as in the JAX package, else to torchrun's
    ``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``. Returns
    True once a multi-process group is up (or already was), False for a
    single process.

    The rank's device: ``device`` where given (``"cpu"`` for a CPU rank),
    else the card ``local_device_ids[0]``, else the card ``LOCAL_RANK``;
    with none of them it raises rather than pick one. The backend:
    ``backend``, else ``QTPU_DIST_BACKEND``, else NCCL for a card and
    ``gloo`` for the CPU (``gloo`` also serves cards, where two ranks share
    one). Every collective, and the bring-up, waits at most ``timeout_s``
    (``QTPU_DIST_TIMEOUT``, default 120 s) for a lost rank, then raises."""
    global _DEVICE
    if dist.is_available() and dist.is_initialized():
        return True
    env = os.environ
    if coordinator_address is None:
        coordinator_address = env.get("QTPU_COORDINATOR")
        if coordinator_address is None and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
            # torchrun's own store (its agent may host it): PyTorch's env:// reads it
            coordinator_address = "env://"
    if num_processes is None:
        num_processes = _env_int("QTPU_NUM_PROCESSES", "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("QTPU_PROCESS_ID", "RANK")
    if num_processes in (None, 0, 1) and coordinator_address is None:
        return False
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("initialize: a multi-process run needs the coordinator's address, "
                         "the number of processes and this process's id")
    dev = _rank_device(local_device_ids, device)
    backend = backend or env.get("QTPU_DIST_BACKEND") or ("nccl" if dev.type == "cuda" else "gloo")
    if timeout_s is None:
        timeout_s = float(env.get("QTPU_DIST_TIMEOUT") or DEFAULT_TIMEOUT_S)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=url, world_size=int(num_processes),
                            rank=int(process_id),
                            timeout=datetime.timedelta(seconds=timeout_s))
    _DEVICE = dev
    logger.info("torch.distributed up: rank %d/%d on %s over %s", dist.get_rank(),
                dist.get_world_size(), dev, backend)
    return True


def shutdown() -> None:
    """Tear the process group down (a no-op for a single process)."""
    global _DEVICE
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _DEVICE = None


def _node_layout() -> Tuple[int, int]:
    """(nodes, ranks per node): from ``LOCAL_WORLD_SIZE`` where the launch
    sets it, else from the hosts' names; (1, world) where the ranks do not
    fall into equal, contiguous nodes."""
    world = dist.get_world_size()
    local = _env_int("LOCAL_WORLD_SIZE")
    if local is None:
        names = [None] * world
        dist.all_gather_object(names, socket.gethostname())
        local = names.count(names[0])
        blocks = [names[i:i + local] for i in range(0, world, local)]
        if world % local or any(len(set(b)) != 1 for b in blocks) or \
                len({b[0] for b in blocks}) != len(blocks):
            return 1, world
    if local <= 0 or world % local:
        return 1, world
    return world // local, local


def make_pod_mesh(axis_sizes: Dict[str, int],
                  dcn_axes: Tuple[str, ...] = ("dp",)) -> "Mesh":  # noqa: F821
    """A mesh whose ``dcn_axes`` span the nodes and whose other axes stay
    within a node: the rank at a mesh coordinate is ``node * L + local``,
    ``node`` from the coordinates on the DCN axes and ``local`` from the
    others (JAX's hybrid mesh, with the node as the granule). One node, or
    axes that do not fit the nodes, fall back to :func:`~.mesh.make_mesh`
    with the same axis names."""
    from .mesh import make_mesh, mesh_from_ranks

    n = int(np.prod(list(axis_sizes.values())))
    if not (dist.is_available() and dist.is_initialized()):
        return make_mesh(axis_sizes)
    world = dist.get_world_size()
    if n > world:
        raise ValueError(f"mesh needs {n} ranks, have {world}")
    nodes, local = _node_layout()
    dcn_total = int(np.prod([axis_sizes[a] for a in dcn_axes if a in axis_sizes]))
    if nodes <= 1 or dcn_total <= 1 or dcn_total % nodes or n != world:
        return make_mesh(axis_sizes)
    names = list(axis_sizes)
    dcn_shape = [axis_sizes[a] if a in dcn_axes else 1 for a in names]
    ici_shape = [1 if a in dcn_axes else axis_sizes[a] for a in names]
    per_node = dcn_total // nodes  # DCN positions sharing one node
    if per_node * (n // dcn_total) != local:
        return make_mesh(axis_sizes)
    ranks = np.empty(tuple(axis_sizes.values()), dtype=np.int64)
    for coord in np.ndindex(*ranks.shape):
        d = int(np.ravel_multi_index([c if s > 1 else 0 for c, s in zip(coord, dcn_shape)],
                                     dcn_shape))
        i = int(np.ravel_multi_index([c if s > 1 else 0 for c, s in zip(coord, ici_shape)],
                                     ici_shape))
        ranks[coord] = (d // per_node) * local + (d % per_node) * int(np.prod(ici_shape)) + i
    return mesh_from_ranks(axis_sizes, ranks)


def parse_mesh_arg(arg: str) -> Dict[str, int]:
    """``"dp=2,tp=4"`` -> ``{"dp": 2, "tp": 4}`` (the CLI's ``--mesh``)."""
    out: Dict[str, int] = {}
    for part in arg.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, size = part.partition("=")
        if not size:
            raise ValueError(f"--mesh entries are name=size, got {part!r}")
        out[name.strip()] = int(size)
    return out
