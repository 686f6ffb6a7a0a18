"""The device mesh (counterpart of bdm_db1_tpu/parallel/mesh.py).

The JAX package lays its devices out as a ("data", "model") mesh, with a
"pipe" axis between them when the pipeline has more than one stage, and
maps the weights' logical axis names onto it. The port keeps the same
shape and names (:func:`mesh_shape`) and builds a
``torch.distributed.device_mesh.DeviceMesh`` over the process world
(:func:`make_mesh`). Data parallelism alone runs over the whole world and
needs no mesh; tensor parallelism (ROADMAP queue 1 item 9b) will take
the mesh's "data" and "model" groups. The logical rules are kept as data
for it too; the placement helpers that read them (the JAX package's
``logical_to_sharding``, ``params_shardings``, ``batch_sharding``,
``replicated`` and ``ring_cache_shardings``) come with it.
"""

from __future__ import annotations

from typing import Optional, Tuple

from bdm_db1_tpu_torch.core.config import MeshConfig

# logical axis name -> mesh axis
LOGICAL_AXIS_RULES: Tuple[Tuple[str, Optional[str]], ...] = (
    ("batch", "data"),
    ("length", None),
    ("length_sharded", "model"),  # Megatron-SP activation sharding
    ("vocab", "model"),
    ("embed", None),
    ("qkv", "model"),
    ("heads", "model"),
    ("head_dim", None),
    ("mlp", "model"),
    ("layers", None),
)


def axis_rules(mesh) -> Tuple[Tuple[str, Optional[str]], ...]:
    """The logical rules of a mesh (a ``DeviceMesh`` or its dim names): on
    a pipelined mesh the stacked layer axis shards across stages;
    otherwise it is replicated."""
    names = getattr(mesh, "mesh_dim_names", mesh)
    if "pipe" in names:
        return tuple(("layers", "pipe") if name == "layers" else (name, tgt)
                     for name, tgt in LOGICAL_AXIS_RULES)
    return LOGICAL_AXIS_RULES


def mesh_shape(cfg: MeshConfig, world: int
               ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(shape, dim names) of the mesh of ``cfg`` over ``world`` devices, as
    the JAX ``make_mesh`` lays them out: data parallel = the rest of the
    devices when ``data_parallel`` is not positive; (dp, pp, tp) named
    ("data", "pipe", "model") when the pipeline has more than one stage,
    else (dp, tp) named ``cfg.axis_names``."""
    tp = max(1, cfg.model_parallel)
    pp = max(1, cfg.pipeline_parallel)
    dp = cfg.data_parallel if cfg.data_parallel > 0 else world // (tp * pp)
    if pp > 1:
        assert dp * pp * tp == world, f"mesh {dp}x{pp}x{tp} != {world} devices"
        return (dp, pp, tp), ("data", "pipe", "model")
    assert dp * tp == world, f"mesh {dp}x{tp} != {world} devices"
    return (dp, tp), tuple(cfg.axis_names)


def make_mesh(cfg: MeshConfig, device_type: str = "cuda"):
    """A ``DeviceMesh`` of :func:`mesh_shape` over the process world (one
    device a process), under the default process group, which must be up;
    ``mesh.get_group("data")`` is the data-parallel group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape, names = mesh_shape(cfg, dist.get_world_size())
    return init_device_mesh(device_type, shape, mesh_dim_names=names)

