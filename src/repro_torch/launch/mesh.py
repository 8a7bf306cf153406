"""Meshes on ``torch.distributed`` (port of ``repro.launch.mesh``): one
process per mesh coordinate.

A :class:`Mesh` has ``shape`` (axis -> size), ``axis_names`` and, when it
is live, this rank's coordinate and a process group for every set of its
axes (``group(axes)``; the one-axis groups are those of
``torch.distributed.device_mesh.init_device_mesh``, ranks in row-major
order of the coordinates). A mesh with no process group is *logical*, like
JAX's ``AbstractMesh``: the spec functions (``distributed.sharding``),
``plan_compile`` and the tests use it. A *dry* mesh (:func:`dry_mesh`) has
one rank's coordinate and no process group behind its groups: its
collectives are counted and answered locally (the dry run's).

The backend is chosen by one rule (:func:`backend_for`), printed by
:func:`init_world`: NCCL when every rank has a card of its own; gloo when
the ranks run on the CPU or share a card (NCCL refuses two ranks on one
device). It is never chosen by catching an NCCL error. The collectives the
port uses (``all_reduce``, ``all_gather``, ``broadcast``) take CUDA tensors
on both backends, so the kernels always run on the rank's device.

:func:`spawn` starts a world of processes on this host (the address is
``tcp://localhost:<free port>``), joins it with a timeout, kills what is
left when the timeout runs out, and returns each rank's result.
"""
from __future__ import annotations

import itertools
import math
import os
import queue as _queue
import socket
import time
import traceback

import torch


class Mesh:
    """A (pod, data, model) mesh. ``shape`` maps axis names to sizes in
    order. ``coordinate`` (axis -> index) and ``groups`` (tuple of axes ->
    process group) are set on a live mesh, None on a logical one."""

    def __init__(self, shape: dict, *, coordinate: dict | None = None, groups: dict | None = None, device=None):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.coordinate = coordinate
        self.groups = groups
        self.device = device

    @property
    def live(self) -> bool:
        return self.groups is not None

    @property
    def dry(self) -> bool:
        """A dry mesh (``dry_mesh``): one rank's coordinate, collectives
        counted and answered locally, no process group."""
        return isinstance(self.groups, _DryGroups)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def axes_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in _axes(axes))

    def index(self, axes) -> int:
        """This rank's row-major index over ``axes`` (0 for no axes)."""
        i = 0
        for a in _axes(axes):
            i = i * self.shape[a] + self.coordinate[a]
        return i

    def group(self, axes):
        """The process group over ``axes`` holding this rank (None for no
        axis or axes of size 1)."""
        axes = tuple(a for a in _axes(axes) if self.shape[a] > 1)
        if not axes:
            return None
        return self.groups[tuple(a for a in self.axis_names if a in axes)]

    def __repr__(self):
        where = "logical" if not self.live else f"rank coordinate {self.coordinate} on {self.device}"
        return f"Mesh({self.shape}, {where}{', dry' if self.dry else ''})"


def _axes(axes) -> tuple:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


_WORLD_DEVICE: list = []  # the device init_world gave this rank


def logical_mesh(shape: tuple, axis_names: tuple) -> Mesh:
    return Mesh(dict(zip(axis_names, shape)))


class _DryGroups(dict):
    """The groups of a dry mesh: a name for every set of axes, no process
    group behind any."""

    def __missing__(self, axes):
        return ("dry", axes)


def dry_mesh(mesh: Mesh, coordinate: dict | None = None, device="cuda") -> Mesh:
    """``mesh``'s shape seen from one rank (``coordinate``; rank 0 by
    default) with no process group: the mesh code paths run as on a live
    mesh, and ``distributed.collectives`` counts each call and answers it
    with an output of the right shape, sending nothing. The dry run
    (``launch.dryrun``) steps one rank this way on fake tensors."""
    coordinate = coordinate if coordinate is not None else {a: 0 for a in mesh.axis_names}
    return Mesh(mesh.shape, coordinate=dict(coordinate), groups=_DryGroups(), device=torch.device(device))


def single_mesh(device="cuda", axis_names: tuple = ("data", "model")) -> Mesh:
    """The live mesh of one process (every axis of size 1): the mesh code
    paths with no collective and no process group."""
    return Mesh({a: 1 for a in axis_names}, coordinate={a: 0 for a in axis_names}, groups={},
                device=torch.device(device))


def backend_for(device, local_world_size: int) -> tuple[str, str]:
    """``(backend, reason)``: NCCL when every rank on this host has a card
    of its own, gloo when the ranks run on the CPU or share a card."""
    device = torch.device(device)
    if device.type != "cuda":
        return "gloo", f"ranks on the {device.type}"
    cards = torch.cuda.device_count()
    if cards >= local_world_size:
        return "nccl", f"{local_world_size} ranks, {cards} cards: one card a rank"
    return "gloo", f"{local_world_size} ranks share {cards} card(s)"


def rank_device(device, backend: str, local_rank: int) -> torch.device:
    """A rank's device: its own card under NCCL, the named device (a shared
    card, or the CPU) under gloo."""
    device = torch.device(device)
    if backend == "nccl":
        return torch.device("cuda", local_rank)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", 0)
    return device


def init_world(device="cuda", *, rank: int | None = None, world_size: int | None = None,
               address: str | None = None, local_rank: int | None = None,
               local_world_size: int | None = None, verbose: bool = True):
    """Join (or start) the default process group on the backend the rule
    picks, and return ``(backend, device)``. Without arguments it reads
    ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``). Rank 0 prints
    the rule's choice."""
    import torch.distributed as dist

    env = os.environ
    rank = int(env["RANK"]) if rank is None else rank
    world_size = int(env["WORLD_SIZE"]) if world_size is None else world_size
    local_rank = int(env.get("LOCAL_RANK", rank)) if local_rank is None else local_rank
    if local_world_size is None:
        local_world_size = int(env.get("LOCAL_WORLD_SIZE", world_size))
    if address is None:
        address = f"tcp://{env.get('MASTER_ADDR', 'localhost')}:{env['MASTER_PORT']}"
    backend, reason = backend_for(device, local_world_size)
    dev = rank_device(device, backend, local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        kw = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method=address, world_size=world_size, rank=rank, **kw)
    _WORLD_DEVICE[:] = [dev]
    if verbose and rank == 0:
        print(f"mesh backend: {backend} ({reason})", flush=True)
    return backend, dev


def init_mesh(shape: tuple, axis_names: tuple = ("data", "model"), device=None) -> Mesh:
    """The live mesh over the initialized world (``init_world`` first):
    ``init_device_mesh`` and its one-axis groups, plus a group for every
    set of two or more axes (the data axes of a three-axis mesh, the whole
    world), all created in the same order on every rank. ``device``: the
    rank's device (default: the one ``init_world`` gave it)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("init_mesh needs an initialized process group (launch.mesh.init_world)")
    if math.prod(shape) != dist.get_world_size():
        raise ValueError(f"mesh {dict(zip(axis_names, shape))} needs {math.prod(shape)} ranks, "
                         f"the world has {dist.get_world_size()}")
    backend = dist.get_backend()
    if device is not None:
        dev = torch.device(device)
    elif _WORLD_DEVICE:
        dev = _WORLD_DEVICE[0]
    else:
        dev = torch.device("cuda", torch.cuda.current_device()) if backend == "nccl" else torch.device("cpu")
    dm = init_device_mesh("cuda" if backend == "nccl" else "cpu", tuple(shape), mesh_dim_names=tuple(axis_names))
    coord = dict(zip(axis_names, dm.get_coordinate()))
    groups = {(a,): dm.get_group(a) for a in axis_names}
    ranks = torch.arange(math.prod(shape)).reshape(shape)
    for k in range(2, len(axis_names) + 1):
        for axes in itertools.combinations(axis_names, k):
            keep = [axis_names.index(a) for a in axes]
            rest = [i for i in range(len(axis_names)) if i not in keep]
            view = ranks.permute(*rest, *keep).reshape(-1, math.prod(shape[i] for i in keep))
            for row in view.tolist():  # every rank creates every group, in one order
                g = dist.new_group(row)
                if dist.get_rank() in row:
                    groups[axes] = g
    return Mesh(dict(zip(axis_names, shape)), coordinate=coord, groups=groups, device=dev)


def _live_or_logical(shape: tuple, axis_names: tuple) -> Mesh:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() == math.prod(shape):
        return init_mesh(shape, axis_names)
    return logical_mesh(shape, axis_names)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: 16x16 (data, model). Multi-pod: 2x16x16 (pod, data,
    model). Live over a world of that size, logical otherwise."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _live_or_logical(shape, axes)


def make_debug_mesh(n_data: int = 2, n_model: int = 2) -> Mesh:
    """A small (data, model) mesh: live over a world of ``n_data ·
    n_model`` ranks, logical otherwise."""
    return _live_or_logical((n_data, n_model), ("data", "model"))


def destroy_world() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker(rank, world_size, port, fn, args, results):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world_size), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world_size), MASTER_ADDR="localhost", MASTER_PORT=str(port))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))  # the ranks share the host's cores
    try:
        out = fn(rank, *args)
    except BaseException:  # noqa: BLE001 - the parent reports the worker's traceback and ends the world
        results.put((rank, "error", traceback.format_exc()))
        return
    results.put((rank, "ok", out))
    destroy_world()


def spawn(fn, world_size: int, args: tuple = (), timeout: float | None = 600.0) -> list:
    """Run ``fn(rank, *args)`` in ``world_size`` fresh processes (the
    ``spawn`` start method; ``fn`` importable by name) with torchrun's
    environment set for ``init_world``; return the results by rank. Raises
    with the worker's traceback if one fails; kills every process still
    running when ``timeout`` seconds run out (None: no limit), and
    raises."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_worker, args=(r, world_size, port, fn, args, results), daemon=True)
             for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + (timeout if timeout is not None else float("inf"))
    out, errors = {}, []
    try:
        while len(out) + len(errors) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"mesh world of {world_size} did not finish in {timeout} s")
            try:
                rank, status, value = results.get(timeout=min(left, 1.0))
            except _queue.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead and not errors:
                    raise RuntimeError(f"mesh rank process exited with code {dead[0].exitcode}")
                continue
            if status == "ok":
                out[rank] = value
            else:
                errors.append((rank, value))
                break
        if errors:
            rank, tb = errors[0]
            raise RuntimeError(f"mesh rank {rank} failed:\n{tb}")
        for p in procs:
            p.join(min(max(deadline - time.monotonic(), 1.0), 60.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
        results.close()
    return [out[r] for r in range(world_size)]
