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
devices. Saves are synchronous, so ``wait`` has nothing to wait for.

Under a process group, ``save`` and ``restore`` are collective: every rank
calls them, on a directory they all see. dcp writes each rank's share of
the replicated tensors once (a key that every rank holds is written by
one of them), only rank 0 renames the finished step and prunes old ones,
between barriers, and a restore starts at a barrier, so it never reads
a step that is still being written. :func:`load_model` reads alone, in
any process.

A tensor-parallel state (``state.model.tp``) is written as whole logical
tensors: each rank gathers the shards of its model group, tensor by
tensor, into host memory, and dcp writes each whole tensor once; a
restore reads the whole tensors into host memory and copies this rank's
slices into the state. The files are those of a one-process run, so a
tensor-parallel world's checkpoint restores in one process and the
reverse, and onto another ``model_parallel``, as an orbax checkpoint
restores onto another mesh.

A pipeline stage's state (``state.model.pp``) holds its own layers under
their global names and the replicated tensors: dcp writes the union of
the stages' tensors, each once, so the files are again a one-process
run's, and a stage restores its own keys from them.
"""

from __future__ import annotations

import json
import os
import shutil
import warnings
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed.checkpoint as dcp

from bdm_db1_tpu_torch.parallel.distributed import barrier, rank_and_world
from bdm_db1_tpu_torch.parallel.mesh import (
    gather_tensor, shard_rule, shard_tensor,
)

CLIENT_FILE = "client.json"
_TMP_PREFIX = ".tmp-"
# dcp says so on every call without a process group; one process is the
# intended use here
_SINGLE_PROCESS = ("torch.distributed is disabled, unavailable or "
                   "uninitialized")


def generator_key(rank: int) -> str:
    """The key of a rank's generator state."""
    return "generator" if rank == 0 else f"generator_rank{rank}"


def state_tensors(state) -> Dict[str, object]:
    """The nested dict of tensors that a checkpoint holds for ``state`` (a
    ``TrainState``) on this rank: views of the state's own tensors, except
    ``step`` and the generator's state, which are copies."""
    out = {"model": state.model.state_dict(),
           "optimizer": state.optimizer.state_dict(),
           "step": torch.tensor(int(state.step), dtype=torch.int64)}
    if state.generator is not None:
        out[generator_key(rank_and_world()[0])] = state.generator.get_state()
    return out


def _sharded_leaves(sd: Dict, cfg):
    """(container, key, (dim, groups)) of every tensor-parallel shard in a
    ``state_tensors`` dict: the model's tensors and the optimizer's
    moments, by the parameter's name."""
    out = []
    for key, t in sd["model"].items():
        out.append((sd["model"], key, shard_rule(key, cfg)))
    for mom in ("mu", "nu"):
        for key in sd.get("optimizer", {}).get(mom, {}):
            out.append((sd["optimizer"][mom], key, shard_rule(key, cfg)))
    return [(c, k, r) for c, k, r in out if r is not None]


def _whole_like(t: torch.Tensor, rule, tp) -> torch.Tensor:
    """An empty host tensor of the whole shape of the shard ``t``."""
    shape = list(t.shape)
    shape[rule[0]] *= tp.size
    return torch.empty(shape, dtype=t.dtype)


def _gathered(sd: Dict, model) -> Dict:
    """``sd`` with every shard replaced by the whole tensor on the host
    (collective over the model group)."""
    tp = getattr(model, "tp", None)
    if tp is None:
        return sd
    out = {**sd, "model": dict(sd["model"])}
    if "optimizer" in sd:
        out["optimizer"] = {k: dict(v) if isinstance(v, dict) else v
                            for k, v in sd["optimizer"].items()}
    for cont, key, rule in _sharded_leaves(out, model.cfg):
        cont[key] = gather_tensor(cont[key], rule, tp).cpu()
    return out


def _load_sharded(sd: Dict, model, load) -> None:
    """``load(target)`` into ``sd`` in place; a tensor-parallel model's
    shards read whole host tensors first, and each takes its slice from
    them (the other tensors are ``sd``'s own)."""
    tp = getattr(model, "tp", None)
    if tp is None:
        load(sd)
        return
    target = {**sd, "model": dict(sd["model"])}
    if "optimizer" in sd:
        target["optimizer"] = {k: dict(v) if isinstance(v, dict) else v
                               for k, v in sd["optimizer"].items()}
    leaves = _sharded_leaves(target, model.cfg)
    for cont, key, rule in leaves:
        cont[key] = _whole_like(cont[key], rule, tp)
    load(target)
    own = _sharded_leaves(sd, model.cfg)
    with torch.no_grad():
        for (cont, key, rule), (whole, _, _) in zip(own, leaves):
            cont[key].copy_(shard_tensor(whole[key], *rule, tp.rank,
                                         tp.size))


def _quiet(fn, *args, **kwargs):
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=_SINGLE_PROCESS)
        return fn(*args, **kwargs)


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
            "bdm_db1_tpu.train.convert.save_deepspeed_checkpoint instead")
    _check_model_keys(model, path)
    _load_sharded({"model": model.state_dict()}, model,
                  lambda sd: _quiet(dcp.load, sd, checkpoint_id=path,
                                    no_dist=True))


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def all_steps(self) -> List[int]:
        """The finished steps on disk, oldest first."""
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit()
                      and os.path.isdir(os.path.join(self.directory, d)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state, client_state: Optional[Dict] = None):
        """Write ``state`` (a ``TrainState``) and the client JSON as step
        ``step``, then prune to ``max_to_keep`` steps."""
        rank = rank_and_world()[0]
        tmp = os.path.join(self.directory, f"{_TMP_PREFIX}{int(step)}")
        if rank == 0:
            shutil.rmtree(tmp, ignore_errors=True)
        barrier()
        _quiet(dcp.save, _gathered(state_tensors(state), state.model),
               checkpoint_id=tmp)
        if rank == 0:
            self._finish(step, tmp, client_state)
        barrier()

    def _finish(self, step: int, tmp: str, client_state: Optional[Dict]):
        """Rank 0: the client JSON, the rename, the pruning."""
        if client_state is not None:
            with open(os.path.join(tmp, CLIENT_FILE), "w") as f:
                json.dump(client_state, f)
        final = self.step_dir(step)
        if os.path.exists(final):
            old = os.path.join(self.directory, f"{_TMP_PREFIX}old-{int(step)}")
            os.rename(final, old)
            os.rename(tmp, final)
            shutil.rmtree(old)
        else:
            os.rename(tmp, final)
        for s in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self.step_dir(s))

    def restore(self, state, step: Optional[int] = None
                ) -> Tuple[Optional[object], Optional[Dict]]:
        """Load step ``step`` (default: the latest) into ``state``'s
        tensors in place: the model, the optimizer (its moments created
        first), ``state.step`` and the generator's state (kept as it is
        when the checkpoint has none). Returns (state, client JSON or
        None), or (None, None) when there is no checkpoint."""
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
        _load_sharded(sd, state.model,
                      lambda t: _quiet(dcp.load, t, checkpoint_id=path))
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
        """Saves are synchronous: nothing is in flight."""

    def close(self) -> None:
        self.wait()
