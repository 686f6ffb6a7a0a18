"""The port's process world and mesh arithmetic (bdm_db1_tpu_torch/parallel/)
against the JAX package's bdm_db1_tpu/parallel/: launcher detection on
tests/test_distributed.py's environments, the initializer's tri-state,
idempotence and its refusal without a rendezvous address, rank and world
size from torchrun, SLURM and OpenMPI, the partitioning helpers, the
logical rules and the mesh shapes of ``make_mesh`` on the 8 virtual CPU
devices."""

import jax
import numpy as np
import pytest
import torch

import bdm_db1_tpu_torch.parallel.distributed as tdist
from bdm_db1_tpu.core.config import MeshConfig as JMesh
from bdm_db1_tpu.parallel import distributed as jdist
from bdm_db1_tpu.parallel import mesh as jmesh
from bdm_db1_tpu.parallel import utils as jutils
from bdm_db1_tpu_torch.core.config import MeshConfig
from bdm_db1_tpu_torch.parallel import mesh as tmesh
from bdm_db1_tpu_torch.parallel import utils as tutils

# the environments of tests/test_distributed.py
JAX_ENVS = [
    {}, {"JAX_COORDINATOR_ADDRESS": "h0:1234"},
    {"COORDINATOR_ADDRESS": "h0:1234"},
    {"MEGASCALE_COORDINATOR_ADDRESS": "h0:8080"},
    {"SLURM_STEP_NUM_TASKS": "4"}, {"SLURM_STEP_NUM_TASKS": "1"},
    {"SLURM_NTASKS": "8"}, {"OMPI_COMM_WORLD_SIZE": "2"},
    {"TPU_WORKER_HOSTNAMES": "w0,w1,w2,w3"}, {"TPU_WORKER_HOSTNAMES": "w0"},
    {"SLURM_STEP_NUM_TASKS": "not-a-number"},
]
ADDR = {"MASTER_ADDR": "h0", "MASTER_PORT": "29500"}


@pytest.mark.parametrize("env", JAX_ENVS, ids=lambda e: ",".join(e) or "bare")
def test_detect_multihost_matches_jax(env):
    assert tdist.detect_multihost(env) == jdist.detect_multihost(env)


@pytest.mark.parametrize("size,want", [("2", True), ("1", False),
                                       ("", False), ("x", False)])
def test_detect_multihost_reads_torchrun_world_size(size, want):
    assert tdist.detect_multihost({"WORLD_SIZE": size}) is want


class _FakeInit:
    def __init__(self):
        self.calls = []

    def __call__(self, **kw):
        self.calls.append(kw)


@pytest.fixture
def fresh(monkeypatch):
    """No process group up and the module's flag cleared."""
    monkeypatch.setattr(tdist, "_initialized", False)
    monkeypatch.setattr(tdist.dist, "is_initialized", lambda: False)


LAUNCH = {"SLURM_STEP_NUM_TASKS": "8", "SLURM_PROCID": "3",
          "SLURM_LOCALID": "1", **ADDR}


def test_initialize_runs_on_detection_once(fresh):
    fake = _FakeInit()
    assert tdist.maybe_initialize_distributed(environ=LAUNCH, backend="gloo",
                                              _init=fake)
    assert fake.calls == [dict(backend="gloo", init_method="tcp://h0:29500",
                               rank=3, world_size=8, timeout=tdist.TIMEOUT)]
    # idempotent: a second driver entry in the same process is a no-op
    assert not tdist.maybe_initialize_distributed(environ=LAUNCH, _init=fake)
    assert len(fake.calls) == 1


@pytest.mark.parametrize("force,env,ran", [
    (True, {"RANK": "0", "WORLD_SIZE": "1", **ADDR}, True),
    (False, LAUNCH, False),
    (None, {}, False),
    (None, {"RANK": "1", "WORLD_SIZE": "2", **ADDR}, True)])
def test_initialize_tri_state(fresh, force, env, ran):
    fake = _FakeInit()
    assert tdist.maybe_initialize_distributed(force, env, "gloo",
                                              _init=fake) is ran
    assert len(fake.calls) == int(ran)


def test_initialize_leaves_a_group_that_is_up(monkeypatch):
    monkeypatch.setattr(tdist, "_initialized", False)
    monkeypatch.setattr(tdist.dist, "is_initialized", lambda: True)
    fake = _FakeInit()
    assert not tdist.maybe_initialize_distributed(True, LAUNCH, _init=fake)
    assert not fake.calls


@pytest.mark.parametrize("env,missing", [
    ({}, "MASTER_ADDR, MASTER_PORT"),
    ({"RANK": "0", "WORLD_SIZE": "2", "MASTER_PORT": "1"}, "MASTER_ADDR"),
    ({"RANK": "0", "WORLD_SIZE": "2", "MASTER_ADDR": "h"}, "MASTER_PORT")])
def test_initialize_without_an_address_raises(fresh, env, missing):
    """force=True as JAX's ``jax.distributed.initialize()`` without a
    coordinator: a ValueError naming what is missing, never one process."""
    fake = _FakeInit()
    with pytest.raises(ValueError, match=missing):
        tdist.maybe_initialize_distributed(True, env, _init=fake)
    assert not fake.calls and not tdist._initialized


def test_initialize_without_a_rank_raises(fresh):
    with pytest.raises(ValueError, match="RANK, WORLD_SIZE"):
        tdist.maybe_initialize_distributed(True, dict(ADDR), _init=_FakeInit())


@pytest.mark.parametrize("env,want", [
    ({"RANK": "5", "WORLD_SIZE": "8", "LOCAL_RANK": "1"}, (5, 8, 1)),
    ({"SLURM_PROCID": "2", "SLURM_STEP_NUM_TASKS": "4",
      "SLURM_LOCALID": "2"}, (2, 4, 2)),
    ({"OMPI_COMM_WORLD_RANK": "7", "OMPI_COMM_WORLD_SIZE": "16",
      "OMPI_COMM_WORLD_LOCAL_RANK": "3"}, (7, 16, 3)),
    # torchrun first when several are set; a missing local rank is 0
    ({"RANK": "1", "WORLD_SIZE": "2", "SLURM_PROCID": "0",
      "SLURM_STEP_NUM_TASKS": "2"}, (1, 2, 0))],
    ids=["torchrun", "slurm", "openmpi", "torchrun_first"])
def test_launcher_ranks(env, want):
    assert tdist.launcher_ranks(env) == want
    assert tdist.local_rank(env) == want[2]


@pytest.mark.parametrize("device,env,want", [
    ("cuda", {"LOCAL_RANK": "3", "RANK": "3", "WORLD_SIZE": "4"}, "cuda:3"),
    ("cuda", {}, "cuda:0"), ("cuda:0", {"RANK": "1", "WORLD_SIZE": "2",
                                        "LOCAL_RANK": "1"}, "cuda:0"),
    ("cpu", {"RANK": "1", "WORLD_SIZE": "2", "LOCAL_RANK": "1"}, "cpu")])
def test_device_for_rank(device, env, want):
    assert tdist.device_for_rank(device, env) == torch.device(want)
    assert tdist.default_backend(device) == (
        "nccl" if want.startswith("cuda") else "gloo")


def test_partitioning_helpers_match_jax():
    for num, den in ((12, 4), (321, 3), (8, 8)):
        assert tutils.divide(num, den) == jutils.divide(num, den)
    with pytest.raises(AssertionError):
        tutils.divide(10, 3)
    for per, rank in ((16, 0), (16, 3)):
        assert (tutils.vocab_range_from_per_partition_size(per, rank)
                == jutils.vocab_range_from_per_partition_size(per, rank))
    for vocab, rank, world in ((64, 1, 4), (33024, 7, 8)):
        assert (tutils.vocab_range_from_global_vocab_size(vocab, rank, world)
                == jutils.vocab_range_from_global_vocab_size(vocab, rank,
                                                             world))
    x = np.arange(2 * 3 * 8).reshape(2, 3, 8)
    for a, b in zip(tutils.split_along_last_dim(x, 4),
                    jutils.split_along_last_dim(x, 4)):
        np.testing.assert_array_equal(a, b)


# (data, model, pipeline) parallel sizes over the 8 CPU devices
MESHES = [(-1, 1, 1), (-1, 2, 1), (2, 4, 1), (-1, 1, 2), (2, 2, 2),
          (-1, 4, 2), (3, 1, 1), (2, 2, 1), (2, 1, 2)]


@pytest.mark.parametrize("dp,tp,pp", MESHES)
def test_mesh_shape_matches_jax(dp, tp, pp):
    """The shape and names of JAX ``make_mesh`` on 8 devices, and its
    assertion where the sizes do not multiply to 8."""
    kw = dict(data_parallel=dp, model_parallel=tp, pipeline_parallel=pp)
    devices = jax.devices()
    assert len(devices) == 8
    try:
        jm = jmesh.make_mesh(JMesh(**kw), devices)
    except AssertionError:
        with pytest.raises(AssertionError, match="devices"):
            tmesh.mesh_shape(MeshConfig(**kw), len(devices))
        return
    shape, names = tmesh.mesh_shape(MeshConfig(**kw), len(devices))
    assert shape == jm.devices.shape and names == jm.axis_names
    assert tmesh.axis_rules(names) == jmesh.axis_rules(jm)


def test_logical_rules_match_jax():
    assert tmesh.LOGICAL_AXIS_RULES == jmesh.LOGICAL_AXIS_RULES


def test_flat_collectives_bucket_and_copy_back(monkeypatch):
    """``_buckets`` splits at a dtype or device change and at
    ``BUCKET_BYTES`` (a larger tensor alone), and ``_flat_collective``
    hands ``fn`` each bucket once, flattened when it holds several
    tensors, and copies the result back into every tensor."""
    monkeypatch.setattr(tdist, "BUCKET_BYTES", 56)
    f32 = [torch.arange(n, dtype=torch.float32) for n in (4, 8, 4, 20, 2)]
    f64 = torch.arange(3, dtype=torch.float64)
    strided = torch.arange(12, dtype=torch.float32).reshape(3, 4).t()
    tensors = f32[:3] + [f64] + f32[3:] + [strided]
    want_sizes = [[4, 8], [4], [3], [20], [2, 12]]
    assert [[t.numel() for t in b] for b in tdist._buckets(tensors)] == \
        want_sizes
    before = [t.clone() for t in tensors]
    seen = []

    def fn(t):
        seen.append(t.numel())
        t.mul_(2)

    tdist._flat_collective(tensors, fn)
    assert seen == [sum(b) for b in want_sizes]
    for t, b in zip(tensors, before):
        assert torch.equal(t, 2 * b)
    assert strided.stride() == (1, 4)
