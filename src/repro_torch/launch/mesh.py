"""The serving mesh of the port: ``torch.distributed`` ranks laid out on
the axes ``("expert", "data")``, one process per rank.

``make_expert_mesh(n_expert_shards, n_data_shards)`` arranges the world's
ranks as an ``(E, D)`` grid (``torch.distributed.device_mesh.
init_device_mesh``): the stacked expert store's leading ``K`` axis splits
over "expert" (each rank holds ``K / E`` resident experts) and a request
batch over "data".  A ``(1, 1)`` mesh is the degenerate single-process
case, which serves bitwise as the unsharded engine does.

Every rank is a process, so the mesh covers the whole world: a mesh
smaller than the world raises (the reference takes a prefix of the
visible devices instead; an idle process would serve nothing).

``init_distributed`` starts the process group: from the environment under
``torchrun`` (``RANK``/``WORLD_SIZE`` set), else a world of one on an
in-memory ``HashStore``.  The backend is named by the caller: ``nccl``
for CUDA tensors, ``gloo`` for the CPU — and for several ranks that share
one card, which NCCL refuses.  Gloo moves CUDA tensors through the host
for its CUDA all-reduce and broadcast; ``ExpertMesh`` stages its
all-gather of CUDA tensors through the host itself (a copy to the CPU,
the CPU all-gather, a copy back), which is the transport of a collective
and no kernel.

Host agreement: ``ExpertMesh.agree`` is a MAX all-reduce of a few host
ints over the world (on the default group when it is gloo, else on a gloo
group of its own), the point at which the ranks of a rolling scheduler
agree on what failed, expired or ran slow in a tick; ``step_agreement``
is the one each rolling step makes before its joins (``PeerFailure`` on
every rank when one failed).  A world of one agrees with itself and
issues nothing.

Every process group the port starts (``init_distributed``, ``spawn``)
has a ``COLLECTIVE_TIMEOUT_S`` limit, so a rank whose peers stopped
raises instead of waiting for ever; ``spawn`` also bounds its join.

``spawn(fn, world, ...)`` runs ``fn(rank, world, *args)`` in
``world`` processes joined by a ``FileStore`` in a temporary directory:
the launcher of the tests and of ``launch/sharded_parity.py`` (no port,
no network).

The LM meshes: ``make_production_mesh`` lays the world out as the
reference's production shapes, ``(16, 16)`` on ``("data", "model")`` and
``(2, 16, 16)`` on ``("pod", "data", "model")`` ("pod" folds into data
parallelism), and ``make_lm_mesh(D, M)`` as any ``(D, M)``; both give an
``LMMesh``, whose ``data_group`` joins the ranks that hold the other
data blocks of the same parameters (``launch.fsdp`` gathers over it).
The dry-run builds the production meshes on a fake world of 256 or 512
ranks (``launch.dryrun``).  ``PEAK_FLOPS_BF16``, ``HBM_BW`` and
``LINK_BW`` are the roofline's denominators: the H100 SXM's, in place of
the reference's TPU v5e constants.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import tempfile
import time

import torch
import torch.distributed as dist

#: the serving mesh's axes, in order
EXPERT_AXES = ("expert", "data")

#: the backend a device's tensors take when the caller names none
_DEFAULT_BACKEND = {"cuda": "nccl", "cpu": "gloo"}

#: the limit of every collective (and of a group's start) of the process
#: groups the port starts: a rank whose peers diverged or died raises
#: after it instead of hanging
COLLECTIVE_TIMEOUT_S = 120.0

#: ``spawn``'s bound on the whole run of its ranks
SPAWN_TIMEOUT_S = 900.0


def _timeout() -> datetime.timedelta:
    return datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S)


class PeerFailure(RuntimeError):
    """Another rank's part of a step failed: raised on every rank that
    did not fail itself, at the step's agreement, before any join."""


def rank_device(device=None) -> torch.device:
    """This process's device: ``device`` (``None`` → ``"cuda"``), a CUDA
    one without an index made concrete — under ``torchrun`` as
    ``cuda:<LOCAL_RANK mod the card count>`` (several ranks may share one
    card), else the current card — and made current."""
    from repro_torch.weights import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            local = (int(os.environ["LOCAL_RANK"])
                     if "LOCAL_RANK" in os.environ
                     else torch.cuda.current_device())
            dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev


def init_distributed(backend: str | None = None, device=None) -> str:
    """Start the default process group unless one is running; returns its
    backend.

    Under ``torchrun`` (``RANK`` and ``WORLD_SIZE`` in the environment)
    the group comes from the environment; otherwise it is a world of one
    on a ``HashStore``.  ``backend`` defaults to the device's own:
    ``nccl`` for ``cuda``, ``gloo`` for ``cpu``.  The device is made
    current first (``rank_device``), as NCCL needs."""
    dev = rank_device(device)
    if dist.is_initialized():
        return dist.get_backend()
    backend = backend or _DEFAULT_BACKEND[dev.type]
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://",
                                timeout=_timeout())
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=_timeout())
    return backend


@dataclasses.dataclass(frozen=True)
class ExpertMesh:
    """This rank's view of an ``("expert", "data")`` mesh.

    ``shape`` (``{"expert": E, "data": D}``) and ``axis_names`` are what
    ``launch.sharding``'s spec functions read, so a stand-in with those
    two attributes serves them as well.  ``expert_index`` and
    ``data_index`` are this rank's coordinates; ``expert_group`` joins the
    ranks that hold the same batch slice (one per expert shard, in expert
    order), ``data_group`` the ranks that hold the same experts.
    ``host_group`` is the gloo group of the host agreements (``None``: the
    default group, when it is gloo); ``counts`` tallies this rank's host
    agreements (``"agreements"``; the steps' own are also counted under
    ``"step_agreements"``) and its joins, the collectives on tensors
    (``"joins"``: each "expert" sum and all-gather).
    """

    shape: dict  # lint: allow-mutable-config (a Mesh's shape is a dict)
    expert_index: int
    data_index: int
    expert_group: object
    data_group: object
    backend: str
    device_mesh: object = None
    axis_names: tuple = EXPERT_AXES
    host_group: object = None
    counts: dict = dataclasses.field(  # lint: allow-mutable-config
        default_factory=lambda: {"agreements": 0, "step_agreements": 0,
                                 "joins": 0},
        compare=False)

    @property
    def rank(self) -> int:
        """This process's rank in the world (0 where no group runs)."""
        return dist.get_rank() if dist.is_initialized() else 0

    @property
    def world(self) -> int:
        return mesh_devices(self)

    def agree(self, flags) -> list[int]:
        """The element-wise MAX of ``flags`` (host ints, the same length
        on every rank) over every rank: one host all-reduce, or ``flags``
        itself in a world of one."""
        flags = [int(f) for f in flags]
        if self.world == 1 or not flags:
            return flags
        t = torch.tensor(flags, dtype=torch.int64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.host_group)
        self.counts["agreements"] += 1
        return t.tolist()  # lint: allow-host-sync — a host tensor

    def step_agreement(self, failed: bool = False) -> None:
        """The agreement a rolling step makes before its joins: a rank
        whose step raised calls it with ``failed`` (in place of the one
        it did not reach), and every other rank then raises
        ``PeerFailure`` here, so no rank is left waiting in a join."""
        self.counts["step_agreements"] += 1
        if self.agree([int(failed)]) != [0] and not failed:
            raise PeerFailure("another rank's step failed")

    def broadcast_object(self, obj):
        """Rank 0's ``obj`` (a picklable host value) on every rank."""
        if self.world == 1:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self.host_group)
        self.counts["agreements"] += 1
        return box[0]

    def barrier(self) -> None:
        """Wait until every rank reaches this point."""
        if self.world > 1:
            dist.barrier(group=self.host_group)

    def expert_range(self, num_experts: int) -> tuple[int, int]:
        """The global ids ``[lo, hi)`` of this rank's resident experts: the
        ``expert_index``-th of ``E`` equal blocks of ``num_experts``.  A
        ``num_experts`` that ``E`` does not divide is replicated (every
        rank holds every expert), as ``sharding.sanitize_spec`` does."""
        e = self.shape["expert"]
        if num_experts % e:
            return 0, num_experts
        n = num_experts // e
        return self.expert_index * n, (self.expert_index + 1) * n

    def data_range(self, batch: int) -> tuple[int, int]:
        """The rows ``[lo, hi)`` of a ``batch`` this rank runs: its block
        of the "data" split, or every row when ``D`` does not divide the
        batch (the batch then replicates, as ``serve_batch_spec`` says)."""
        d = self.shape["data"]
        if batch % d:
            return 0, batch
        n = batch // d
        return self.data_index * n, (self.data_index + 1) * n

    def _host_staged(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.is_cuda

    def expert_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the "expert" group: one ``all_reduce`` on a
        contiguous copy (or on ``t`` itself when contiguous), returned.
        Where each element is non-zero on at most one rank the sum is that
        rank's value exactly."""
        t = t.contiguous()
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.expert_group)
        self.counts["joins"] += 1
        return t

    def _gather(self, t: torch.Tensor, group, size: int) -> torch.Tensor:
        """Every rank's ``t`` of ``group``, concatenated along dim 0 in
        group-rank order (host-staged for CUDA tensors on gloo)."""
        src = t.contiguous()
        if self._host_staged(src):
            src = src.cpu()
        parts = [torch.empty_like(src) for _ in range(size)]
        dist.all_gather(parts, src, group=group)
        self.counts["joins"] += 1
        return torch.cat(parts).to(t.device)

    def expert_gather(self, t: torch.Tensor) -> torch.Tensor:
        """The "expert" group's ``t`` blocks, stacked in expert order."""
        return self._gather(t, self.expert_group, self.shape["expert"])

    def data_gather(self, t: torch.Tensor) -> torch.Tensor:
        """The "data" group's batch slices, concatenated in row order."""
        return self._gather(t, self.data_group, self.shape["data"])


def make_expert_mesh(n_expert_shards: int = 1,
                     n_data_shards: int | None = None, *,
                     device=None, backend: str | None = None) -> ExpertMesh:
    """The ``("expert", "data")`` serving mesh over the process group's
    world (started by ``init_distributed`` when none runs).

    ``n_data_shards=None`` folds the ranks left over into "data".  Raises
    the reference's ``ValueError``s: a shard count below 1, and a mesh
    that needs more ranks than the world holds ("visible devices" are the
    world's ranks here).  A mesh that needs fewer ranks than the world
    holds raises too (each rank is a process that would serve nothing).
    """
    from torch.distributed.device_mesh import init_device_mesh

    if n_expert_shards < 1:
        raise ValueError(
            f"n_expert_shards must be >= 1, got {n_expert_shards}")
    dev = rank_device(device)
    # the world the process group has, or will have: checked before one
    # is started
    ndev = (dist.get_world_size() if dist.is_initialized()
            else int(os.environ.get("WORLD_SIZE", "1")))
    if n_data_shards is None:
        n_data_shards = max(1, ndev // n_expert_shards)
    if n_data_shards < 1:
        raise ValueError(f"n_data_shards must be >= 1, got {n_data_shards}")
    need = n_expert_shards * n_data_shards
    if need > ndev:
        raise ValueError(
            f"mesh ({n_expert_shards}, {n_data_shards}) needs {need} "
            f"devices but only {ndev} are visible"
        )
    if need < ndev:
        raise ValueError(
            f"mesh ({n_expert_shards}, {n_data_shards}) covers {need} of "
            f"the {ndev} ranks; every rank must serve a shard"
        )
    backend = init_distributed(backend, dev)
    dm = init_device_mesh(dev.type, (n_expert_shards, n_data_shards),
                          mesh_dim_names=EXPERT_AXES)
    e_idx, d_idx = dm.get_coordinate()
    # the host agreements need a gloo group where the world's is not
    host_group = None
    if ndev > 1 and dist.get_backend() != "gloo":
        host_group = dist.new_group(backend="gloo", timeout=_timeout())
    return ExpertMesh(
        shape={"expert": n_expert_shards, "data": n_data_shards},
        expert_index=int(e_idx), data_index=int(d_idx),
        expert_group=dm.get_group("expert"), data_group=dm.get_group("data"),
        backend=backend, device_mesh=dm, host_group=host_group)


@dataclasses.dataclass(frozen=True)
class LMMesh:
    """This rank's view of an LM mesh: ``("data", "model")`` or
    ``("pod", "data", "model")``.

    ``shape`` and ``axis_names`` are what ``launch.sharding``'s spec
    functions read.  ``data_index`` is this rank's block over the data
    axes (pod-major: ``pod · D + data``) and ``data_group`` joins the
    ranks that hold the other blocks (``launch.fsdp`` gathers a layer
    over it, reduce-scatters its gradient and averages the replicated
    gradients).  ``backend`` is the group's (``"fake"`` on the dry-run's
    world, where nothing is exchanged).
    """

    shape: dict  # lint: allow-mutable-config (a Mesh's shape is a dict)
    axis_names: tuple
    data_index: int
    data_group: object
    backend: str
    device_mesh: object = None

    @property
    def data_size(self) -> int:
        """The ranks over the data axes ("pod" times "data")."""
        n = 1
        for a in data_axes(self):
            n *= self.shape[a]
        return n


#: the production meshes' shapes and axes (the reference's)
PRODUCTION_MESHES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def _lm_mesh(shape: tuple, axes: tuple, dev: torch.device) -> LMMesh:
    """``shape`` over ``axes`` on the running world, which must have
    ``prod(shape)`` ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    need = 1
    for n in shape:
        need *= n
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise ValueError(
            f"mesh {tuple(shape)} on {axes} needs a world of {need} ranks, "
            f"not {world}")
    dm = init_device_mesh(dev.type, tuple(shape), mesh_dim_names=axes)
    coord = dict(zip(axes, (int(c) for c in dm.get_coordinate())))
    if "pod" in axes:
        group = dm["pod", "data"]._flatten("pod_data").get_group()
        index = coord["pod"] * shape[axes.index("data")] + coord["data"]
    else:
        group, index = dm.get_group("data"), coord["data"]
    return LMMesh(shape=dict(zip(axes, shape)), axis_names=axes,
                  data_index=index, data_group=group,
                  backend=dist.get_backend(), device_mesh=dm)


def make_production_mesh(*, multi_pod: bool = False, device=None
                         ) -> LMMesh:
    """The reference's production mesh over the running world: ``(16,
    16)`` on ``("data", "model")``, or ``(2, 16, 16)`` on ``("pod",
    "data", "model")`` with ``multi_pod``.  Raises ``ValueError`` where
    the world (1 where no process group runs) is not 256 or 512 ranks.
    ``device`` (``None`` → ``"cuda"``) names the mesh's device type."""
    shape, axes = PRODUCTION_MESHES[bool(multi_pod)]
    dev = torch.device("cuda" if device is None else device)
    return _lm_mesh(shape, axes, dev)


def make_lm_mesh(n_data: int = 1, n_model: int = 1, *, device=None,
                 backend: str | None = None) -> LMMesh:
    """A ``(n_data, n_model)`` mesh on ``("data", "model")`` over the
    world (started by ``init_distributed`` when none runs: a world of one
    outside ``torchrun`` or ``spawn``), which must have ``n_data ·
    n_model`` ranks.  The port executes the "data" axes only: a step on a
    mesh whose "model" axis is over 1 raises (``launch.fsdp.install``)."""
    if n_data < 1 or n_model < 1:
        raise ValueError(f"mesh ({n_data}, {n_model}): sizes must be >= 1")
    dev = rank_device(device)
    init_distributed(backend, dev)
    return _lm_mesh((n_data, n_model), ("data", "model"), dev)


@dataclasses.dataclass(frozen=True)
class HostMesh:
    """The one-process ``(1, 1)`` mesh under the production axis names."""

    shape: dict = dataclasses.field(  # lint: allow-mutable-config
        default_factory=lambda: {"data": 1, "model": 1})
    axis_names: tuple = ("data", "model")


def make_host_mesh() -> HostMesh:
    """1-process mesh for CPU tests (same axis names as the production
    mesh, ``("data", "model")``)."""
    return HostMesh()


def data_axes(mesh) -> tuple[str, ...]:
    """The batch-sharding axes of a mesh ("pod" folds into data)."""
    names = mesh.axis_names
    return ("pod", "data") if "pod" in names else ("data",)


def mesh_devices(mesh) -> int:
    """The ranks a mesh spans."""
    n = 1
    for size in mesh.shape.values():
        n *= size
    return n


def _spawned(rank, fn, world, store_path, backend, device, args):
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, store=dist.FileStore(store_path, world), rank=rank,
        world_size=world, timeout=_timeout())
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, *args, backend: str = "gloo",
          device: str = "cpu") -> None:
    """Run ``fn(rank, world, *args)`` in ``world`` fresh processes (the
    ``spawn`` start method) whose default process group is ``backend``
    over a ``FileStore`` in a temporary directory; CUDA ranks take
    ``cuda:<rank mod the card count>``.  Returns when every rank has;
    raises if one failed, and ``TimeoutError`` (the ranks terminated) if
    they have not all returned within ``SPAWN_TIMEOUT_S``.  ``fn`` must
    be importable by name."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="repro_torch_mesh_") as d:
        ctx = mp.spawn(_spawned, args=(fn, world, os.path.join(d, "store"),
                                       backend, device, args),
                       nprocs=world, join=False)
        give_up = time.monotonic() + SPAWN_TIMEOUT_S
        while not ctx.join(timeout=1.0):
            if time.monotonic() >= give_up:
                for p in ctx.processes:
                    if p.is_alive():
                        p.terminate()
                for p in ctx.processes:
                    p.join()
                raise TimeoutError(
                    f"spawn: {world} ranks of {fn.__name__} still running "
                    f"after {SPAWN_TIMEOUT_S:.0f} s")


# --- H100 SXM constants (per card) — the roofline's denominators ----------
#: dense bf16 tensor-core peak (NVIDIA H100 SXM datasheet)
PEAK_FLOPS_BF16 = 989e12          # FLOP/s
#: HBM3 bandwidth (NVIDIA H100 SXM datasheet)
HBM_BW = 3.35e12                  # bytes/s
#: NVLink 4 bandwidth each way: 900 GB/s total (NVIDIA H100 SXM datasheet)
LINK_BW = 450e9                   # bytes/s
