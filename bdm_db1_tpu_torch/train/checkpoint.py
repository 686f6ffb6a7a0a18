"""Checkpointing with resume (counterpart of bdm_db1_tpu/train/checkpoint.py),
on ``torch.distributed.checkpoint``.

One directory per step under ``directory``::

    <directory>/<step>/.metadata        the tensors' index (dcp)
    <directory>/<step>/__<r>_0.distcp   the tensors that rank r wrote
    <directory>/<step>/client.json      the client state, when given

The tensors of a train state, by key: ``model.<parameter or buffer name>``
(the model's state dict, so a model loads from ``model.*`` alone),
``optimizer.count``, ``optimizer.mu.<name>``, ``optimizer.nu.<name>`` (the
optimizer's ``state_dict``, train/step.py), ``step`` (int64) and the
dropout ``torch.Generator``'s state bytes, when the state has one:
``generator`` for rank 0, ``generator_rank<r>`` for rank r of a
data-parallel run, whose ranks draw from generators of their own. A step
is written under a temporary name and renamed when complete, so
``latest_step`` sees only finished steps; saving a step that exists
replaces it. After each save only the newest ``max_to_keep`` steps stay.
``restore`` loads in place into the given state's own tensors, on their
devices.

Saves are asynchronous, as orbax's are with ``enable_async_checkpointing``:
``save`` copies this rank's tensors into host memory that the manager
owns (pinned when they live on the card; allocated at the first save and
reused while the shapes and dtypes stay) and returns once the copy is
complete, so the next optimizer step may update the state in place; a
background thread writes the files from that copy. A save waits for the
one before it, and ``wait``, ``close``, ``restore``, ``latest_step`` and
``all_steps`` wait for the manager's save in flight; an error of the
write is raised by the next of these calls (or ``save``), and its step
never appears.

Under a process group, ``save`` and ``restore`` are collective: every rank
calls them, on a directory they all see. The background write's
collectives go over a gloo group of the manager's own, made at its first
save, so they never meet the training's collectives on the default or the
model and data groups. dcp writes each rank's share of the replicated
tensors once (a key that every rank holds is written by one of them);
once every rank's files and the index are written, rank 0 renames the
step and prunes old ones, and the ranks' writes end together. A restore
starts at a barrier, so it never reads a step that is still being
written. :func:`load_model` reads alone, in any process.

A tensor-parallel state (``state.model.tp``) is written in place: each
rank writes only its own slices of the sharded tensors, under the whole
tensor's key, each slice a chunk at its offset in the whole tensor (a
shard of ``groups`` blocks, qkv_net's or the GEGLU input's, is that many
chunks, parallel/mesh.py ``shard_tensor``). The files hold the keys and
whole shapes of a one-process run, so a tensor-parallel world's
checkpoint restores in one process and the reverse, and onto another
``model_parallel``, as an orbax checkpoint restores onto another mesh; a
restore at the same ``model_parallel`` reads only this rank's chunks,
straight into the state's tensors.

A pipeline stage's state (``state.model.pp``) holds its own layers under
their global names and the replicated tensors: dcp writes the union of
the stages' tensors, each once, so the files are again a one-process
run's, and a stage restores its own keys from them.
"""

from __future__ import annotations

import dataclasses
import json
import mmap
import os
import shutil
import threading
import time
import warnings
import weakref
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp
from torch.distributed.checkpoint.default_planner import (
    DefaultLoadPlanner, DefaultSavePlanner, create_default_local_load_plan,
)
from torch.distributed.checkpoint.metadata import (
    ChunkStorageMetadata, MetadataIndex, TensorProperties,
)
from torch.distributed.checkpoint.planner import (
    TensorWriteData, WriteItem, WriteItemType,
)
from torch.distributed.checkpoint.planner_helpers import (
    create_read_items_for_chunk_list,
)

from bdm_db1_tpu_torch.parallel.distributed import (
    TIMEOUT, barrier, rank_and_world,
)
from bdm_db1_tpu_torch.parallel.mesh import shard_rule

CLIENT_FILE = "client.json"
_TMP_PREFIX = ".tmp-"
# dcp says so on every call without a process group; one process is the
# intended use here
_SINGLE_PROCESS = ("torch.distributed is disabled, unavailable or "
                   "uninitialized")
# each staged tensor starts at a multiple of this many bytes
_ALIGN = 64


def generator_key(rank: int) -> str:
    """The key of a rank's generator state."""
    return "generator" if rank == 0 else f"generator_rank{rank}"


def state_tensors(state) -> Dict[str, object]:
    """The nested dict of tensors that a checkpoint holds for ``state`` (a
    ``TrainState``) on this rank: views of the state's own tensors, except
    ``step`` and the generator's state, which are copies. A state whose
    optimizer is None (the convert CLI's, train/convert.py) has no
    ``optimizer`` entry."""
    out = {"model": state.model.state_dict(),
           "step": torch.tensor(int(state.step), dtype=torch.int64)}
    if state.optimizer is not None:
        out["optimizer"] = state.optimizer.state_dict()
    if state.generator is not None:
        out[generator_key(rank_and_world()[0])] = state.generator.get_state()
    return out


def _chunks(t: torch.Tensor, rule, tp) -> Tuple[torch.Size, List]:
    """(the whole tensor's shape, [(offsets, view)]) of this rank's shard
    ``t``: of each of the ``groups`` blocks along ``dim``, this rank's
    part, at its offset in the whole tensor (``shard_tensor``'s layout)."""
    dim, groups = rule
    n = t.shape[dim] // groups
    whole = list(t.shape)
    whole[dim] *= tp.size
    parts = []
    for g in range(groups):
        off = [0] * t.dim()
        off[dim] = (g * tp.size + tp.rank) * n
        parts.append((torch.Size(off), t.narrow(dim, g * n, n)))
    return torch.Size(whole), parts


def _split(sd: Dict, model) -> Tuple[Dict, Dict]:
    """(``sd`` without the tensor-parallel shards, {key: (path, whole
    shape, [(offsets, view)])} of the shards: the model's sharded tensors
    and the optimizer's moments of sharded parameters, by :func:`_chunks`).
    Without ``model.tp``, (``sd``, {})."""
    tp = getattr(model, "tp", None)
    if tp is None:
        return sd, {}
    chunks = {}

    def walk(d, path):
        out = {}
        for k, v in d.items():
            p = path + (k,)
            if isinstance(v, dict):
                out[k] = walk(v, p)
                continue
            sharded = p[:1] == ("model",) or p[:2] in (("optimizer", "mu"),
                                                      ("optimizer", "nu"))
            rule = shard_rule(k, model.cfg) if sharded else None
            if rule is None:
                out[k] = v
            else:
                chunks[".".join(p)] = (p, *_chunks(v, rule, tp))
        return out

    return walk(sd, ()), chunks


def _map_tensors(d: Dict, fn) -> Dict:
    """The nested dict ``d`` with ``fn`` of each tensor (in ``d``'s order);
    other values as they are."""
    return {k: _map_tensors(v, fn) if isinstance(v, dict)
            else fn(v) if isinstance(v, torch.Tensor) else v
            for k, v in d.items()}


class _ChunkSavePlanner(DefaultSavePlanner):
    """dcp's planner, and a write item for each chunk of ``chunks`` (keys
    as :func:`_split`'s, the views host copies): a tensor-parallel rank's
    slices under the whole tensor's key."""

    def __init__(self, chunks: Dict):
        super().__init__()
        self._chunks = {(key, off): t for key, (_, _, parts) in chunks.items()
                        for off, t in parts}
        self._items = [
            WriteItem(index=MetadataIndex(key, off), type=WriteItemType.SHARD,
                      tensor_data=TensorWriteData(
                          chunk=ChunkStorageMetadata(off, t.shape),
                          properties=TensorProperties(dtype=t.dtype),
                          size=whole))
            for key, (_, whole, parts) in chunks.items() for off, t in parts]
        self._paths = {key: path for key, (path, _, _) in chunks.items()}

    def create_local_plan(self):
        plan = super().create_local_plan()
        self.plan = dataclasses.replace(
            plan, items=plan.items + self._items,
            planner_data={**(plan.planner_data or {}), **self._paths})
        return self.plan

    def lookup_object(self, index: MetadataIndex):
        t = self._chunks.get((index.fqn, index.offset))
        return t if t is not None else super().lookup_object(index)


class _ChunkLoadPlanner(DefaultLoadPlanner):
    """dcp's planner, and the reads that fill each chunk of ``chunks``
    (keys as :func:`_split`'s, the views the state's own tensors) from
    the saved chunks that overlap it."""

    def __init__(self, chunks: Dict):
        super().__init__()
        self._chunks = chunks
        self._targets = {(key, off): t for key, (_, _, parts) in chunks.items()
                         for off, t in parts}

    def create_local_plan(self):
        plan = create_default_local_load_plan(self.state_dict, self.metadata)
        saved = self.metadata.state_dict_metadata
        for key, (_, whole, parts) in self._chunks.items():
            if key not in saved:
                raise RuntimeError(f"Missing key in checkpoint state_dict: "
                                   f"{key}.")
            if saved[key].size != whole:
                raise ValueError(f"Size mismatch between saved "
                                 f"{saved[key].size} and current: {whole} "
                                 f"for {key}")
            plan.items.extend(create_read_items_for_chunk_list(
                key, saved[key], [ChunkStorageMetadata(off, t.shape)
                                  for off, t in parts]))
        return plan

    def lookup_tensor(self, index: MetadataIndex):
        t = self._targets.get((index.fqn, index.offset))
        return t if t is not None else super().lookup_tensor(index)


def _quiet(fn, *args, **kwargs):
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=_SINGLE_PROCESS)
        return fn(*args, **kwargs)


def _load(sd: Dict, model, path: str, **kwargs) -> None:
    """``dcp.load`` of ``sd`` from the step directory ``path``, in place; a
    tensor-parallel model's shards read only their own chunks."""
    rest, chunks = _split(sd, model)
    _quiet(dcp.load, rest, checkpoint_id=path,
           planner=_ChunkLoadPlanner(chunks), **kwargs)


def _unregister(ptr: int) -> None:
    try:
        torch.cuda.cudart().cudaHostUnregister(ptr)
    except Exception:       # CUDA already torn down at exit
        pass


class _Staging:
    """Host copies of a rank's checkpoint tensors, each a tensor of its own
    storage in one anonymous mapping (so dcp writes each without a further
    copy), page-locked for the card when a source lives there."""

    def __init__(self, sources: List[torch.Tensor]):
        t0 = time.perf_counter()
        sizes = [t.numel() * t.element_size() for t in sources]
        offsets, total = [], 0
        for n in sizes:
            offsets.append(total)
            total += -(-n // _ALIGN) * _ALIGN
        self.nbytes = sum(sizes)
        # MAP_POPULATE faults the pages in at once, so registering them
        # only locks them (faulting them in during the registration is
        # slower)
        self._map = mmap.mmap(-1, max(total, 1), flags=(
            mmap.MAP_PRIVATE | mmap.MAP_ANONYMOUS
            | getattr(mmap, "MAP_POPULATE", 0)))
        self.pinned = any(t.is_cuda for t in sources)
        if self.pinned:
            # the buffer protocol gives the mapping's address
            base = torch.frombuffer(self._map, dtype=torch.uint8).data_ptr()
            err = int(torch.cuda.cudart().cudaHostRegister(base, total, 1))
            if err:
                raise RuntimeError(f"cudaHostRegister of {total} bytes for "
                                   f"the checkpoint's host copy failed "
                                   f"(error {err})")
            self._release = weakref.finalize(self, _unregister, base)
        self.tensors = [
            torch.frombuffer(self._map, dtype=torch.uint8, count=n,
                             offset=off).view(t.dtype).view(t.shape)
            if n else torch.empty(t.shape, dtype=t.dtype)
            for t, n, off in zip(sources, sizes, offsets)]
        self.alloc_s = time.perf_counter() - t0

    def copy_from(self, sources: List[torch.Tensor]) -> None:
        """Copy ``sources`` in; complete when this returns."""
        devices = set()
        with torch.no_grad():
            for dst, src in zip(self.tensors, sources):
                dst.copy_(src, non_blocking=src.is_cuda)
                if src.is_cuda:
                    devices.add(src.device)
        for d in devices:
            torch.cuda.current_stream(d).synchronize()

    def close(self) -> None:
        if self.pinned:
            self._release()
        self.tensors = []


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        self._group = None          # the writes' gloo group
        self._staging = None        # (signature, _Staging)
        self._thread = None         # the write in flight
        self._error = None
        # the last save's staging: seconds to allocate (0 when reused) and
        # to copy, and bytes
        self.last_stage: Dict[str, float] = {}

    def step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def _steps(self) -> List[int]:
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit()
                      and os.path.isdir(os.path.join(self.directory, d)))

    def all_steps(self) -> List[int]:
        """The finished steps on disk, oldest first (after this manager's
        save in flight)."""
        self.wait()
        return self._steps()

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _stage(self, sd: Dict, model) -> Tuple[Dict, Dict]:
        """Host copies of ``sd``'s tensors, complete: (the nested dict of
        the copies, chunks as :func:`_split`'s with copies for views)."""
        rest, chunks = _split(sd, model)
        sources = []
        _map_tensors(rest, sources.append)
        sources += [t for _, _, parts in chunks.values() for _, t in parts]
        sig = [(t.shape, t.dtype, t.device) for t in sources]
        fresh = self._staging is None or self._staging[0] != sig
        if fresh:
            if self._staging is not None:
                self._staging[1].close()
            self._staging = None
            self._staging = (sig, _Staging(sources))
        buf = self._staging[1]
        t0 = time.perf_counter()
        buf.copy_from(sources)
        self.last_stage = {"alloc_s": buf.alloc_s if fresh else 0.0,
                           "copy_s": time.perf_counter() - t0,
                           "bytes": buf.nbytes, "pinned": buf.pinned}
        copies = iter(buf.tensors)
        staged = _map_tensors(rest, lambda t: next(copies))
        staged_chunks = {key: (path, whole, [(off, next(copies))
                                             for off, _ in parts])
                         for key, (path, whole, parts) in chunks.items()}
        return staged, staged_chunks

    def save(self, step: int, state, client_state: Optional[Dict] = None):
        """Copy ``state`` (a ``TrainState``) into the manager's host memory
        and return; a background thread writes it and the client JSON as
        step ``step``, then prunes to ``max_to_keep`` steps. Waits for the
        save before it first (and raises its error)."""
        self.wait()
        if self._group is None and dist.is_available() \
                and dist.is_initialized():
            self._group = dist.new_group(backend="gloo", timeout=TIMEOUT)
        staged, chunks = self._stage(state_tensors(state), state.model)
        device = next((p.device for p in state.model.parameters()
                       if p.is_cuda), None)
        self._thread = threading.Thread(
            target=self._write, name=f"checkpoint-save-{int(step)}",
            args=(int(step), staged, chunks, client_state, device))
        self._thread.checkpoint_dir = self.directory   # wait_for_saves
        self._thread.start()

    def _write(self, step: int, staged: Dict, chunks: Dict,
               client_state: Optional[Dict], device) -> None:
        """The background write of a staged step (every rank's thread)."""
        rank = rank_and_world()[0]
        tmp = os.path.join(self.directory, f"{_TMP_PREFIX}{step}")
        try:
            if device is not None:      # dcp's queries go to this card
                torch.cuda.set_device(device)
            if rank == 0:
                shutil.rmtree(tmp, ignore_errors=True)
            if self._group is not None:
                dist.barrier(group=self._group)
            # per_thread_copy_ahead 0: the staged tensors are on the host,
            # and dcp's copy-ahead loader would synchronize the card
            _quiet(dcp.save, staged,
                   storage_writer=dcp.FileSystemWriter(
                       tmp, per_thread_copy_ahead=0),
                   planner=_ChunkSavePlanner(chunks),
                   process_group=self._group)
            if rank == 0:
                self._finish(step, tmp, client_state)
            if self._group is not None:
                dist.barrier(group=self._group)
        except BaseException as e:
            # dcp raises every rank's errors as one CheckpointException (a
            # BaseException): this rank's own error, when it had one
            own = getattr(e, "failures", {}).get(rank)
            self._error = own[0] if own else e
            if rank == 0:
                shutil.rmtree(tmp, ignore_errors=True)

    def _finish(self, step: int, tmp: str, client_state: Optional[Dict]):
        """Rank 0: the client JSON, the rename, the pruning."""
        if client_state is not None:
            with open(os.path.join(tmp, CLIENT_FILE), "w") as f:
                json.dump(client_state, f)
        final = self.step_dir(step)
        if os.path.exists(final):
            old = os.path.join(self.directory, f"{_TMP_PREFIX}old-{step}")
            os.rename(final, old)
            os.rename(tmp, final)
            shutil.rmtree(old)
        else:
            os.rename(tmp, final)
        for s in self._steps()[:-self.max_to_keep]:
            shutil.rmtree(self.step_dir(s))

    def restore(self, state, step: Optional[int] = None
                ) -> Tuple[Optional[object], Optional[Dict]]:
        """Load step ``step`` (default: the latest) into ``state``'s
        tensors in place: the model, the optimizer (its moments created
        first), ``state.step`` and the generator's state (kept as it is
        when the checkpoint has none). Returns (state, client JSON or
        None), or (None, None) when there is no checkpoint."""
        self.wait()
        barrier()
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        path = self.step_dir(step)
        _check_model_keys(state.model, path)
        sd = state_tensors(state)
        gen = generator_key(rank_and_world()[0])
        saved = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
        if gen not in saved:    # saved from a state (or rank) without one
            sd.pop(gen, None)
        _load(sd, state.model, path)
        state.optimizer.load_state_dict(sd["optimizer"])
        state.step = int(sd["step"])
        if gen in sd:
            state.generator.set_state(sd[gen])
        client = None
        client_path = os.path.join(path, CLIENT_FILE)
        if os.path.exists(client_path):
            with open(client_path) as f:
                client = json.load(f)
        return state, client

    def wait(self) -> None:
        """Wait for the save in flight; raise its error, if it failed."""
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join()
        error, self._error = self._error, None
        if error is not None:
            raise error

    def close(self) -> None:
        """Wait for the save in flight and free the host copy."""
        try:
            self.wait()
        finally:
            if self._staging is not None:
                self._staging[1].close()
                self._staging = None


def wait_for_saves(directory: str) -> None:
    """Wait for every save in flight in this process to ``directory``,
    whichever manager made it (its error stays with that manager's
    ``wait``): a reader in the process that saved sees its last step."""
    directory = os.path.abspath(directory)
    for t in threading.enumerate():
        if getattr(t, "checkpoint_dir", None) == directory:
            t.join()


def _check_model_keys(model: torch.nn.Module, path: str) -> None:
    """Raise, naming them, when the step directory ``path`` lacks model
    tensors (a checkpoint written before the model had them, e.g. one
    without the vision tower)."""
    saved = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    missing = [k for k in model.state_dict() if f"model.{k}" not in saved]
    if missing:
        raise ValueError(
            f"checkpoint {path} has no tensors for {len(missing)} model "
            f"names: {', '.join(missing[:8])}"
            + (", ..." if len(missing) > 8 else "")
            + " (written by an older version of the port?)")


def load_model(model: torch.nn.Module, path: str) -> None:
    """Read only the ``model.*`` tensors of the step directory ``path``
    into ``model``, in place, cast to its tensors' dtypes (a
    tensor-parallel model: its slices of them)."""
    if not os.path.exists(os.path.join(path, ".metadata")):
        raise ValueError(
            f"{path} is not a checkpoint of this package (a JAX/orbax one?); "
            "write JAX params as a DeepSpeed model_states.pt with "
            "bdm_db1_tpu.train.convert.save_deepspeed_checkpoint instead "
            "(the port's weights go to the same format through "
            "bdm_db1_tpu_torch.train.convert.save_deepspeed_checkpoint)")
    _check_model_keys(model, path)
    _load({"model": model.state_dict()}, model, path, no_dist=True)
