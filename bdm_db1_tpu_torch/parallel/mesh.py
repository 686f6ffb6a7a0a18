"""The device mesh (counterpart of bdm_db1_tpu/parallel/mesh.py).

The JAX package lays its devices out as a ("data", "model") mesh, with a
"pipe" axis between them when the pipeline has more than one stage, and
maps the weights' logical axis names onto it. The port keeps the same
shape and names (:func:`mesh_shape`) and builds a
``torch.distributed.device_mesh.DeviceMesh`` over the process world
(:func:`make_mesh`). Data parallelism alone runs over the whole world and
needs no mesh; tensor parallelism takes the mesh's "data" and "model"
groups (:class:`TensorParallel`), the pipeline its "data" and "pipe"
groups (:class:`PipelineParallel`): rank r sits at (d, s, t) with
r = (d * pp + s) * tp + t, JAX's row-major layout.

The port has one device a process, so a sharded weight is explicit: each
rank's modules hold only its shard, made by the placement helpers below
from the same logical rules (:data:`PARAM_AXES` through
:func:`logical_to_sharding`; :func:`shard_state_dict` and its inverse
:func:`gather_state_dict`; :func:`batch_sharding`; :func:`replicated`;
:func:`ring_cache_shardings`, the local cache shapes).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

from bdm_db1_tpu_torch.core.config import MeshConfig, ModelConfig

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
    ``mesh.get_group("data")`` is the data-parallel group,
    ``mesh.get_group("model")`` the tensor-parallel one and, with more
    than one stage, ``mesh.get_group("pipe")`` the pipeline's. Rank r sits
    at (r // tp, r % tp), JAX's row-major (dp, tp) layout, or at (d, s, t)
    with r = (d * pp + s) * tp + t on a (dp, pp, tp) mesh."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape, names = mesh_shape(cfg, dist.get_world_size())
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


# ---- tensor parallelism: the placement of each parameter ----------------

# the logical axes of each parameter in the port's torch layout (an
# nn.Linear weight is [out, in]), by the end of its name: the JAX package's
# annotations (models/transformer_xl.py) transposed. The int8 decode
# weights (``weight_q`` [N, K], ``weight_scale`` [N]) follow their matrix.
# Every other parameter and buffer is replicated: LayerNorms, the timestep
# embedding, the FF output bias (added once, after the reduce), the
# positional table and the vision tower.
PARAM_AXES: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("word_embedding.weight", ("vocab", "embed")),
    ("lm_head.weight", ("vocab", "embed")),
    ("qkv_net.weight", ("qkv", "embed")),
    ("qkv_net.weight_q", ("qkv", "embed")),
    ("qkv_net.weight_scale", ("qkv",)),
    ("r_net.weight", ("qkv", "embed")),
    ("o_net.weight", ("embed", "heads")),
    ("o_net.weight_q", ("embed", "heads")),
    ("r_w_bias", ("heads", "head_dim")),
    ("r_r_bias", ("heads", "head_dim")),
    ("CoreNet.0.weight", ("mlp", "embed")),
    ("CoreNet.0.weight_q", ("mlp", "embed")),
    ("CoreNet.0.weight_scale", ("mlp",)),
    ("CoreNet.0.bias", ("mlp",)),
    ("CoreNet.2.weight", ("embed", "mlp")),
    ("CoreNet.2.weight_q", ("embed", "mlp")),
)


def param_axes(name: str) -> Optional[Tuple[str, ...]]:
    """The logical axes of the parameter (or buffer) ``name``, or None when
    it is replicated."""
    for suffix, axes in PARAM_AXES:
        if name == suffix or name.endswith("." + suffix):
            return axes
    return None


def logical_to_sharding(axes: Optional[Sequence[str]]) -> Optional[int]:
    """The dim of a tensor with logical ``axes`` that LOGICAL_AXIS_RULES
    map onto "model", or None (replicated over the model group)."""
    if axes is None:
        return None
    rules = dict(LOGICAL_AXIS_RULES)
    dims = [i for i, a in enumerate(axes) if rules.get(a) == "model"]
    return dims[0] if dims else None


def shard_rule(name: str, cfg: ModelConfig) -> Optional[Tuple[int, int]]:
    """(dim, groups) of the parameter ``name`` under tensor parallelism, or
    None when it is replicated. ``groups`` > 1: the dim holds that many
    blocks side by side, and a rank takes its slice of each block: qkv_net
    is [q || k || v] (3; a contiguous slice would give rank 0 all of q),
    the GEGLU input matrix [value || gate] (2, activations.geglu)."""
    dim = logical_to_sharding(param_axes(name))
    if dim is None:
        return None
    groups = 1
    if "qkv_net." in name:
        groups = 3
    elif "CoreNet.0." in name and cfg.activation_fn == "geglu":
        groups = 2
    return dim, groups


def shard_tensor(t: torch.Tensor, dim: int, groups: int, rank: int,
                 size: int) -> torch.Tensor:
    """Rank ``rank`` of ``size``'s slice of ``t`` along ``dim``: of each of
    its ``groups`` blocks, the rank-th of ``size`` equal parts (a
    contiguous copy)."""
    blocks = t.unflatten(dim, (groups, t.shape[dim] // groups))
    n = blocks.shape[dim + 1] // size
    return blocks.narrow(dim + 1, rank * n, n).flatten(
        dim, dim + 1).contiguous()


def unshard_tensor(parts: Sequence[torch.Tensor], dim: int,
                   groups: int) -> torch.Tensor:
    """The inverse of :func:`shard_tensor` over every rank's part, in rank
    order."""
    blocks = [p.unflatten(dim, (groups, p.shape[dim] // groups))
              for p in parts]
    return torch.cat(blocks, dim + 1).flatten(dim, dim + 1)


def replicated(name: str) -> bool:
    """Whether the parameter ``name`` is whole on every rank of a model
    group."""
    return param_axes(name) is None


def check_tensor_parallel(cfg: ModelConfig, padded_vocab: int,
                          size: int) -> None:
    """``ValueError`` naming the field when ``size`` ranks cannot split the
    model: a rank holds whole heads, an equal share of the FF width (of
    each GEGLU half) and of the padded vocab."""
    d_mid = cfg.d_inner // (2 if cfg.activation_fn == "geglu" else 1)
    for field, n in (("n_head", cfg.n_head), ("d_inner / 2" if
                     cfg.activation_fn == "geglu" else "d_inner", d_mid),
                     ("padded vocab", padded_vocab)):
        if n % size:
            raise ValueError(
                f"mesh.model_parallel = {size} does not divide {field} "
                f"({n}): a rank cannot hold a fraction of it")


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """This process's place in a (data, model) mesh: its rank in the model
    group (``group``, ``size`` ranks that hold one model's shards) and in
    the data group (``data_group``, the ranks of the other replicas that
    hold the same shard). ``sequence_sharded``: Megatron-SP, the trunk's
    activations between the blocks shard along the sequence over the
    model group."""

    rank: int
    size: int
    group: object = None
    data_rank: int = 0
    data_size: int = 1
    data_group: object = None
    sequence_sharded: bool = False


def tensor_parallel(mesh, sequence_sharded: bool = False) -> TensorParallel:
    """The :class:`TensorParallel` of this process in ``mesh`` (a
    ``DeviceMesh`` named ("data", "model"))."""
    return TensorParallel(
        rank=mesh.get_local_rank("model"), size=mesh.size(
            mesh.mesh_dim_names.index("model")),
        group=mesh.get_group("model"),
        data_rank=mesh.get_local_rank("data"),
        data_size=mesh.size(mesh.mesh_dim_names.index("data")),
        data_group=mesh.get_group("data"),
        sequence_sharded=sequence_sharded)


def shard_state_dict(full: Mapping[str, torch.Tensor], tp: TensorParallel,
                     cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """This rank's state dict from a whole one: each sharded tensor's slice
    (:func:`shard_tensor`), the others as they are."""
    out = {}
    for name, t in full.items():
        rule = shard_rule(name, cfg)
        out[name] = (t if rule is None else
                     shard_tensor(t, *rule, tp.rank, tp.size))
    return out


def gather_tensor(t: torch.Tensor, rule: Optional[Tuple[int, int]],
                  tp: TensorParallel) -> torch.Tensor:
    """The whole tensor of this rank's shard ``t`` (collective over the
    model group; ``t`` itself when ``rule`` is None)."""
    import torch.distributed as dist

    if rule is None:
        return t
    parts = [torch.empty_like(t) for _ in range(tp.size)]
    dist.all_gather(parts, t.contiguous(), group=tp.group)
    return unshard_tensor(parts, *rule)


def gather_state_dict(local: Mapping[str, torch.Tensor], tp: TensorParallel,
                      cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The whole state dict from every rank's shards, on every rank of the
    model group (collective; every rank passes the same names in the same
    order)."""
    return {n: gather_tensor(t, shard_rule(n, cfg), tp)
            for n, t in local.items()}


def batch_sharding(par) -> Tuple[int, int]:
    """(index, count) of this process's share of a global batch or of the
    env list: the data rank of ``par`` (a :class:`TensorParallel` or
    :class:`PipelineParallel`, or None), so the ranks of one model group
    and of one pipeline read the same rows (the world rank without
    either)."""
    if par is not None:
        return par.data_rank, par.data_size
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def data_axis(tp: Optional[TensorParallel],
              pp: Optional[PipelineParallel]):
    """What a batch is sharded by (:func:`batch_sharding`) and its
    gradients are summed over (``data_group``): the pipeline place ``pp``,
    else the tensor-parallel place ``tp``, else None. Under both they
    share one data group."""
    return pp if pp is not None else tp


def ring_cache_shardings(cfg: ModelConfig, batch_size: int,
                         tp: Optional[TensorParallel]) -> Dict[str, tuple]:
    """The local shapes of a rank's ring cache: [L, B, M, H / tp, Dh], the
    int8 scales [L, B, M, H / tp] (the JAX ``ring_cache_shardings`` puts
    the heads on "model"). The cache is allocated at these shapes: the
    kernels take packed heads, not a strided view of the whole cache."""
    h = cfg.n_head // (tp.size if tp is not None else 1)
    shape = (cfg.n_layer, batch_size, cfg.mem_len, h, cfg.d_head)
    return {"k": shape, "v": shape, "k_scale": shape[:-1],
            "v_scale": shape[:-1]}


# ---- pipeline parallelism: a stage's layers --------------------------------

def check_pipeline_parallel(n_layer: int, size: int) -> None:
    """``ValueError`` naming ``n_layer`` when ``size`` stages cannot hold
    equal shares of the layer stack (the JAX ``pipeline_trunk`` asserts
    it)."""
    if n_layer % size:
        raise ValueError(
            f"mesh.pipeline_parallel = {size} does not divide n_layer "
            f"({n_layer}): each stage holds n_layer / stages layers")


def stage_layers(n_layer: int, stage: int, size: int) -> range:
    """The global indices of the layers stage ``stage`` of ``size`` holds:
    [s * n_layer / S, (s + 1) * n_layer / S)."""
    check_pipeline_parallel(n_layer, size)
    n = n_layer // size
    return range(stage * n, (stage + 1) * n)


def pipe_replicated(name: str) -> bool:
    """Whether the parameter (or buffer) ``name`` is whole on every stage
    (the embeddings, the head, the shared r_w_bias/r_r_bias, the vision
    tower, as JAX replicates them over "pipe"); a layer's (``h.{i}.*``)
    lives on one stage."""
    return not name.startswith("h.")


def layer_index(name: str) -> Optional[int]:
    """The global layer index of a layer's tensor (``h.{i}.*``), else
    None."""
    return int(name.split(".")[1]) if name.startswith("h.") else None


def stage_state_dict(full: Mapping[str, torch.Tensor], pp,
                     n_layer: int) -> Dict[str, torch.Tensor]:
    """A pipeline stage's entries of a whole state dict: the replicated
    tensors and its own layers' (:func:`stage_layers`)."""
    ids = pp.layers(n_layer)
    return {n: t for n, t in full.items()
            if pipe_replicated(n) or layer_index(n) in ids}


@dataclasses.dataclass(frozen=True)
class PipelineParallel:
    """This process's place in a (data, pipe, model) mesh: ``stage`` of
    ``size`` stages, the pipe ``group`` (the ranks at the same (d, t),
    one a stage), the world ranks of the stages before and after it
    (None at the ends), the data group (the ranks at the same (s, t)),
    and ``n_micro``, the pipeline micro-batches a micro-batch is split
    into."""

    stage: int
    size: int
    group: object = None
    prev_rank: Optional[int] = None
    next_rank: Optional[int] = None
    data_rank: int = 0
    data_size: int = 1
    data_group: object = None
    n_micro: int = 2

    @property
    def first(self) -> bool:
        return self.stage == 0

    @property
    def last(self) -> bool:
        return self.stage == self.size - 1

    def layers(self, n_layer: int) -> range:
        return stage_layers(n_layer, self.stage, self.size)


def pipeline_parallel(mesh, microbatches: int = -1) -> PipelineParallel:
    """The :class:`PipelineParallel` of this process in ``mesh`` (a
    ``DeviceMesh`` named ("data", "pipe", "model")); ``microbatches`` > 0
    sets ``n_micro``, otherwise it is twice the stages (the JAX
    ``make_sharded_train_step``'s default)."""
    import torch.distributed as dist

    group = mesh.get_group("pipe")
    stage = mesh.get_local_rank("pipe")
    size = mesh.size(mesh.mesh_dim_names.index("pipe"))
    return PipelineParallel(
        stage=stage, size=size, group=group,
        prev_rank=(dist.get_global_rank(group, stage - 1) if stage > 0
                   else None),
        next_rank=(dist.get_global_rank(group, stage + 1)
                   if stage < size - 1 else None),
        data_rank=mesh.get_local_rank("data"),
        data_size=mesh.size(mesh.mesh_dim_names.index("data")),
        data_group=mesh.get_group("data"),
        n_micro=microbatches if microbatches > 0 else 2 * size)
