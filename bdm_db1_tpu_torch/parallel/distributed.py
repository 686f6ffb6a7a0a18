"""The process world (counterpart of bdm_db1_tpu/parallel/distributed.py).

A multi-process run is started by a launcher (torchrun, SLURM's srun,
OpenMPI's mpirun), one process per card. :func:`detect_multihost` reads the
launcher's per-rank environment as the JAX package does, and also
torchrun's ``WORLD_SIZE``; :func:`maybe_initialize_distributed` brings up
the ``torch.distributed`` process group from the rank and world size the
launcher exported and the rendezvous address in ``MASTER_ADDR`` and
``MASTER_PORT``. A failed rendezvous raises: a run that asked for several
processes never goes on as one.

Data parallelism's collectives: :func:`barrier`, :func:`summed` (the
loss-mask count of a micro-batch, the loss), :func:`all_reduce_flat`,
which sums a list of tensors over a group in a few flat buckets (the
gradients, once a step), and :func:`broadcast_flat`, which sends them
from one rank (the initial parameters). Tensor parallelism's autograd
collectives over the model group close the module (:func:`copy_to_tp`,
:func:`reduce_from_tp`, :func:`gather_from_tp`, :func:`scatter_to_tp`,
:func:`reduce_scatter_tp`).
``COLLECTIVES`` counts the calls that reach ``torch.distributed``.
"""

from __future__ import annotations

import datetime
import os
from typing import Callable, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# presence of any of these implies a multi-process launch (the JAX
# package's rendezvous variables)
_COORDINATOR_VARS = (
    "JAX_COORDINATOR_ADDRESS",
    "COORDINATOR_ADDRESS",
    "MEGASCALE_COORDINATOR_ADDRESS",
)
# numeric world sizes; > 1 implies a multi-process launch. Per-rank
# variables only (set by the launcher on each process it starts):
# SLURM_NTASKS describes the allocation and is visible to a lone python
# too, which would then wait for ranks that never start.
_WORLD_SIZE_VARS = (
    "JAX_NUM_PROCESSES",
    "SLURM_STEP_NUM_TASKS",   # srun, for the job step's ranks
    "OMPI_COMM_WORLD_SIZE",   # mpirun, per rank
    "PMI_SIZE",               # the PMI launcher, per rank
    "WORLD_SIZE",             # torchrun, per rank
)
_TPU_HOSTLIST_VAR = "TPU_WORKER_HOSTNAMES"
# (rank, world size, local rank) as each launcher exports them, in the
# order they are tried
LAUNCHER_VARS = (
    ("RANK", "WORLD_SIZE", "LOCAL_RANK"),                          # torchrun
    ("SLURM_PROCID", "SLURM_STEP_NUM_TASKS", "SLURM_LOCALID"),     # srun
    ("OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE",               # mpirun
     "OMPI_COMM_WORLD_LOCAL_RANK"),
)
ADDRESS_VARS = ("MASTER_ADDR", "MASTER_PORT")
# how long a collective waits for the other ranks before it raises. Rank
# 0's in-training evaluation (RL rollouts, captions, VQA) holds the other
# ranks at the barrier after the eval hook (train/trainer.py), for longer
# than NCCL's default of 10 minutes on a long suite.
TIMEOUT = datetime.timedelta(hours=1)
# the flat buckets of all_reduce_flat / broadcast_flat
BUCKET_BYTES = 128 << 20
COLLECTIVES = {"all_reduce": 0, "broadcast": 0, "all_gather": 0}

_initialized = False


def detect_multihost(environ: Optional[Mapping[str, str]] = None) -> bool:
    """True when the process environment indicates a multi-process launch."""
    env = os.environ if environ is None else environ
    if any(env.get(k) for k in _COORDINATOR_VARS):
        return True
    for k in _WORLD_SIZE_VARS:
        v = env.get(k, "").strip()
        if v.isdigit() and int(v) > 1:
            return True
    hosts = env.get(_TPU_HOSTLIST_VAR, "").strip()
    if hosts and len(hosts.split(",")) > 1:
        return True
    return False


def launcher_ranks(environ: Optional[Mapping[str, str]] = None
                   ) -> Tuple[int, int, int]:
    """(rank, world size, local rank) from the first launcher of
    ``LAUNCHER_VARS`` whose rank and world size are both set (local rank 0
    when it is not); ``ValueError`` when none is."""
    env = os.environ if environ is None else environ
    for rank, world, local in LAUNCHER_VARS:
        r, w = env.get(rank, "").strip(), env.get(world, "").strip()
        if r.isdigit() and w.isdigit():
            lr = env.get(local, "").strip()
            return int(r), int(w), int(lr) if lr.isdigit() else 0
    names = "; ".join(f"{r}, {w}" for r, w, _ in LAUNCHER_VARS)
    raise ValueError(f"a multi-process run needs its rank and world size "
                     f"from the launcher: none of ({names}) is set")


def local_rank(environ: Optional[Mapping[str, str]] = None) -> int:
    """The launcher's local rank, 0 without a launcher."""
    try:
        return launcher_ranks(environ)[2]
    except ValueError:
        return 0


def default_backend(device) -> str:
    """"nccl" for a CUDA device, "gloo" for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def maybe_initialize_distributed(
    force: Optional[bool] = None,
    environ: Optional[Mapping[str, str]] = None,
    backend: Optional[str] = None,
    _init: Optional[Callable] = None,
) -> bool:
    """Bring up the default process group when appropriate; returns whether
    this call did.

    ``force`` is the ``--mesh.multihost`` tri-state: ``True`` always
    initializes, ``False`` never does, ``None`` auto-detects
    (:func:`detect_multihost`). A process group that is already up is left
    as it is (so a caller can choose its own, as tests do with gloo), and
    a second call is a no-op. Rank and world size come from the launcher
    (:func:`launcher_ranks`), the address from ``MASTER_ADDR`` and
    ``MASTER_PORT``: ``ValueError`` naming what is missing. ``backend``
    defaults to :func:`default_backend` of the card when one is visible.
    A collective that waits ``TIMEOUT`` raises. ``environ`` and ``_init``
    exist for tests."""
    global _initialized
    if _initialized or force is False:
        return False
    if dist.is_available() and dist.is_initialized():
        return False
    env = os.environ if environ is None else environ
    if force is None and not detect_multihost(env):
        return False
    missing = [k for k in ADDRESS_VARS if not env.get(k, "").strip()]
    if missing:
        raise ValueError(
            f"a multi-process run needs the rendezvous address in "
            f"{' and '.join(ADDRESS_VARS)}: {', '.join(missing)} not set")
    rank, world, _ = launcher_ranks(env)
    if backend is None:
        backend = default_backend(
            "cuda" if torch.cuda.is_available() else "cpu")
    init = dist.init_process_group if _init is None else _init
    init(backend=backend,
         init_method=f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
         rank=rank, world_size=world, timeout=TIMEOUT)
    _initialized = True
    return True


def device_for_rank(device, environ: Optional[Mapping[str, str]] = None
                    ) -> torch.device:
    """The device of this process: ``"cuda"`` without an index becomes
    ``cuda:<local rank>``; an explicit index and the CPU stay as given."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", local_rank(environ))
    return dev


def world_group():
    """The default process group when one is up, else None."""
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


def rank_and_world(group=None) -> Tuple[int, int]:
    """This process's rank in ``group`` (default: the world) and the
    group's size; (0, 1) without a process group."""
    if not (dist.is_available() and dist.is_initialized()):
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def barrier() -> None:
    """``dist.barrier()`` when a process group is up."""
    if dist.is_available() and dist.is_initialized():
        dist.barrier()


def summed(t: torch.Tensor, group=None) -> torch.Tensor:
    """A copy of ``t`` summed over ``group`` (one ``all_reduce``)."""
    out = t.detach().clone()
    COLLECTIVES["all_reduce"] += 1
    dist.all_reduce(out, group=group)
    return out


def _buckets(tensors: Sequence[torch.Tensor]) -> List[List[torch.Tensor]]:
    """Consecutive runs of tensors of one dtype and device, each at most
    ``BUCKET_BYTES`` (a larger tensor alone)."""
    out: List[List[torch.Tensor]] = []
    size = 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        last = out[-1] if out else None
        if (last is None or last[0].dtype != t.dtype
                or last[0].device != t.device
                or size + nbytes > BUCKET_BYTES):
            out.append([t])
            size = nbytes
        else:
            last.append(t)
            size += nbytes
    return out


def _flat_collective(tensors, fn) -> None:
    """``fn`` in place on each bucket of ``tensors``, flattened into one
    tensor when it holds several, and the results copied back."""
    for bucket in _buckets(tensors):
        if len(bucket) == 1 and bucket[0].is_contiguous():
            fn(bucket[0])
            continue
        flat = torch.cat([t.reshape(-1) for t in bucket])
        fn(flat)
        for t, part in zip(bucket, flat.split([t.numel() for t in bucket])):
            t.copy_(part.view_as(t))


def all_reduce_flat(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Sum each tensor over ``group`` in place: one ``all_reduce`` a flat
    bucket (``_buckets``). Every rank must pass tensors of the same shapes
    in the same order."""
    def fn(t):
        COLLECTIVES["all_reduce"] += 1
        dist.all_reduce(t, group=group)

    _flat_collective(tensors, fn)


def broadcast_flat(tensors: Sequence[torch.Tensor], src: int = 0,
                   group=None) -> None:
    """Overwrite each tensor with rank ``src``'s, one ``broadcast`` a flat
    bucket."""
    def fn(t):
        COLLECTIVES["broadcast"] += 1
        dist.broadcast(t, src=src, group=group)

    _flat_collective(tensors, fn)


# ---- tensor parallelism's collectives over the model group -------------
#
# Megatron's four: a row-parallel product gives its output through
# reduce_from_tp (the partial sums reduced forward, identity backward),
# or reduce_scatter_tp along the sequence under the sequence-sharded
# option; the vocab-parallel head takes its input through copy_to_tp
# (identity forward, the input gradient's partial sums reduced backward)
# and gives its logits through gather_from_tp. The trunk's column-parallel
# products do copy_to_tp's work in _ColumnParallelLinear (models/
# transformer_xl.py), which gathers the sequence under the option and
# sums, or reduce-scatters, its input gradient itself. The sums run in f32 on every backend:
# gloo may refuse a bf16 all_reduce, and a sum of bf16 partials rounded
# once after the sum is the same on NCCL and gloo. Reduce-scatter is an
# all_reduce and a slice (gloo has no reduce_scatter of one tensor).


def all_reduce_f32(t: torch.Tensor, group, op=None) -> torch.Tensor:
    """``t`` summed (or ``op``) over ``group`` in f32, cast back to its
    dtype."""
    out = t.float().contiguous()
    if out is t:
        out = t.clone()
    COLLECTIVES["all_reduce"] += 1
    dist.all_reduce(out, op=op or dist.ReduceOp.SUM, group=group)
    return out.to(t.dtype)


def _all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    COLLECTIVES["all_gather"] += 1
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim)


def _local_chunk(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's equal part of ``t`` along ``dim``."""
    r, n = dist.get_rank(group), dist.get_world_size(group)
    return t.chunk(n, dim)[r].contiguous()


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce_f32(g, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_f32(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _local_chunk(g, ctx.group, ctx.dim), None, None


class _ScatterToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _local_chunk(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.dim), None, None


class _ReduceScatterTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _local_chunk(all_reduce_f32(x, group), group, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.dim), None, None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; backward, the gradient summed over ``group`` (the
    input of the vocab-parallel head; the trunk's column-parallel products
    take theirs through ``_ColumnParallelLinear``, which sums its input
    gradient itself)."""
    return _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` (in f32, cast back) forward; identity
    backward (the output of a row-parallel product)."""
    return _ReduceFromTP.apply(x, group)


def gather_from_tp(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` forward; backward this
    rank's part of the gradient (every rank holds the whole gradient:
    vocab-sharded logits, the trunk's output)."""
    return _GatherFromTP.apply(x, group, dim % x.dim())


def scatter_to_tp(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's equal part of ``x`` along ``dim`` forward; backward the
    parts' gradients gathered."""
    return _ScatterToTP.apply(x, group, dim % x.dim())


def reduce_scatter_tp(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """``x`` summed over ``group`` and this rank's part along ``dim`` taken
    (forward); backward the parts' gradients gathered (the output of a
    row-parallel product under the sequence-sharded option)."""
    return _ReduceScatterTP.apply(x, group, dim % x.dim())


def all_reduce_max(t: torch.Tensor, group) -> torch.Tensor:
    """``t``'s elementwise max over ``group`` (no gradient)."""
    return all_reduce_f32(t, group, dist.ReduceOp.MAX)
