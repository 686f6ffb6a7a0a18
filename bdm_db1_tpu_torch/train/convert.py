"""Weight bridges into the port's model: the JAX package's param tree, and
a torch/DeepSpeed checkpoint file of the reference.

The JAX param tree -> the port's state dict follows
bdm_db1_tpu/train/convert.py ``invert_state_dict`` (scan-stacked
layers unstacked, flax kernels [in, out] transposed to torch [out, in],
reference torch names, conv kernels HWIO -> OIHW), with the port's two
layout choices: the word embedding and an untied head keep the padded
vocab rows, and the shared ``r_w_bias``/``r_r_bias`` pair is listed under
every layer. Any leaf the bridge does not consume is an error.

A DeepSpeed ``model_states.pt`` (bdm_db1_tpu/train/convert.py
``load_torch_state_dict``, ``find_deepspeed_model_states``) holds the
reference torch names already: :func:`load_deepspeed_checkpoint` pads the
word embedding (and an untied head) to the padded vocab with zero rows, as
the JAX converter does, and loads it.

A JAX tree without the ``vision`` subtree (a model initialised on a batch
without images), or a DeepSpeed file without ``vision_encoder.*``, leaves
the port's vision tower at its init: the loaders then return its names,
and every other name must be present and taken.

The way out, :func:`save_deepspeed_checkpoint`, writes the port's weights
as the JAX package's function of that name writes its params: the
reference's ``mp_rank_00_model_states.pt`` (fp16 by default), the vocab
rows cut to the real ones, so that the reference, the JAX package and the
port all read it. A sharded model is gathered first. :func:`main` is the
convert CLI: a DeepSpeed file into step 0 of a port checkpoint.
"""

from __future__ import annotations

import os
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

from bdm_db1_tpu_torch.core.config import DB1Config
from bdm_db1_tpu_torch.parallel.distributed import barrier, rank_and_world
from bdm_db1_tpu_torch.parallel.mesh import (
    gather_state_dict, shard_state_dict, stage_state_dict,
)

VISION_KEY = "vision"
VISION_PREFIX = "vision_encoder."
MODEL_STATES = "mp_rank_00_model_states.pt"
# the tensors with a row per padded vocab entry
_VOCAB_ROWS = ("word_embedding.weight", "lm_head.weight")
# flax name -> the reference torch module under vision_encoder.patch_embeddings
_PATCH_CONVS = {"conv_in": "conv1", "conv_mid1": "residual_path.2",
                "conv_mid2": "residual_path.5", "projection": "projection"}
_PATCH_NORMS = {"gn1": "residual_path.0", "gn2": "residual_path.3"}


def _leaf_paths(tree, prefix=()) -> List[Tuple[str, ...]]:
    if isinstance(tree, Mapping):
        out = []
        for k in tree:
            out += _leaf_paths(tree[k], prefix + (k,))
        return out
    return [prefix]


def _inv_freq(n_embed: int) -> np.ndarray:
    """The sinusoidal positional buffer, as the JAX converter rebuilds it."""
    return (1.0 / (10000.0 ** (np.arange(0.0, n_embed, 2.0) / n_embed))
            ).astype(np.float32)


def state_dict_from_jax(params_np: Mapping, cfg: DB1Config
                        ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """JAX params (nested dicts of arrays, boxes already removed) -> (the
    port's state dict as f32 CPU tensors, the JAX leaves it did not take:
    none, since every leaf is taken or raises). The vision tower's names
    are in the state dict only when the tree has the ``vision`` subtree."""
    m = cfg.model
    L = m.n_layer
    used = set()

    def g(*ks) -> np.ndarray:
        node = params_np
        for k in ks:
            node = node[k]
        used.add(ks)
        return np.asarray(node, dtype=np.float32)

    sd: Dict[str, np.ndarray] = {
        "word_embedding.weight": g("word_embedding", "embedding"),
        "rl_local_timestep_embedding.weight":
            g("rl_timestep_embedding", "embedding"),
        "pos_emb.inv_freq": _inv_freq(m.n_embed),
    }
    if not m.untie_r:
        sd["r_w_bias"] = g("r_w_bias")
        sd["r_r_bias"] = g("r_r_bias")
        for i in range(L):
            sd[f"h.{i}.dec_attn.r_w_bias"] = sd["r_w_bias"]
            sd[f"h.{i}.dec_attn.r_r_bias"] = sd["r_r_bias"]

    def unstack(fmt: str, arr: np.ndarray, transpose: bool = False) -> None:
        if arr.shape[0] != L:
            raise ValueError(f"{fmt}: leading dim {arr.shape[0]} != {L}")
        for i in range(L):
            sd[fmt.format(i=i)] = arr[i].T if transpose else arr[i]

    a = ("layers", "attn")
    unstack("h.{i}.dec_attn.qkv_net.weight", g(*a, "qkv_net", "kernel"), True)
    unstack("h.{i}.dec_attn.r_net.weight", g(*a, "r_net", "kernel"), True)
    unstack("h.{i}.dec_attn.o_net.weight", g(*a, "o_net", "kernel"), True)
    unstack("h.{i}.dec_attn.layer_norm.weight", g(*a, "layer_norm", "scale"))
    unstack("h.{i}.dec_attn.layer_norm.bias", g(*a, "layer_norm", "bias"))
    if m.untie_r:
        unstack("h.{i}.dec_attn.r_w_bias", g(*a, "r_w_bias"))
        unstack("h.{i}.dec_attn.r_r_bias", g(*a, "r_r_bias"))
    f = ("layers", "ff")
    unstack("h.{i}.pos_ff.CoreNet.0.weight", g(*f, "wi", "kernel"), True)
    unstack("h.{i}.pos_ff.CoreNet.0.bias", g(*f, "wi", "bias"))
    unstack("h.{i}.pos_ff.CoreNet.2.weight", g(*f, "wo", "kernel"), True)
    unstack("h.{i}.pos_ff.CoreNet.2.bias", g(*f, "wo", "bias"))
    unstack("h.{i}.pos_ff.layer_norm.weight", g(*f, "layer_norm", "scale"))
    unstack("h.{i}.pos_ff.layer_norm.bias", g(*f, "layer_norm", "bias"))
    if not m.share_input_output_embedding:
        sd["lm_head.weight"] = g("lm_head", "kernel").T
    if VISION_KEY in params_np:
        vp = VISION_PREFIX + "patch_embeddings."
        patch = (VISION_KEY, "patch")
        for flax_name, torch_name in _PATCH_CONVS.items():
            # flax HWIO -> torch OIHW
            sd[vp + torch_name + ".weight"] = np.transpose(
                g(*patch, flax_name, "kernel"), (3, 2, 0, 1))
            sd[vp + torch_name + ".bias"] = g(*patch, flax_name, "bias")
        for flax_name, torch_name in _PATCH_NORMS.items():
            sd[vp + torch_name + ".weight"] = g(*patch, flax_name, "scale")
            sd[vp + torch_name + ".bias"] = g(*patch, flax_name, "bias")
        for axis in ("row", "col"):
            sd[f"{VISION_PREFIX}{axis}_position_embeddings.weight"] = g(
                VISION_KEY, f"{axis}_pos", "embedding")

    left = [p for p in _leaf_paths(params_np) if p not in used]
    if left:
        raise ValueError("JAX params the port does not take: "
                         + ", ".join("/".join(p) for p in left))
    out = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}
    return out, []


def load_into(model: torch.nn.Module, sd: Mapping[str, torch.Tensor]
              ) -> List[str]:
    """``model.load_state_dict(sd)`` (cast to the model's dtypes and
    device), strict except that the vision tower may be absent as a whole:
    then it stays at its init and its names are returned (else []). ``sd``
    is a whole model's; a pipeline stage (``model.pp``) loads its layers
    and the replicated tensors of it (parallel/mesh.py
    ``stage_state_dict``), a tensor-parallel model (``model.tp``) this
    rank's shard of that (``shard_state_dict``)."""
    pp = getattr(model, "pp", None)
    if pp is not None:
        sd = stage_state_dict(sd, pp, model.cfg.n_layer)
    tp = getattr(model, "tp", None)
    if tp is not None:
        sd = shard_state_dict(sd, tp, model.cfg)
    own = model.state_dict().keys()
    missing = sorted(set(own) - set(sd))
    vision = sorted(k for k in own if k.startswith(VISION_PREFIX))
    unexpected = sorted(set(sd) - set(own))
    if unexpected or missing not in ([], vision):
        raise ValueError(f"state dict does not fit the model: missing "
                         f"{missing[:8]}, unexpected {unexpected[:8]}")
    model.load_state_dict(sd, strict=not missing)
    return missing


def load_jax_params(model: torch.nn.Module, params_np: Mapping) -> List[str]:
    """Load JAX params into ``model`` (values cast to the model's parameter
    dtype and device). Returns the names left at their init: the vision
    tower's when the tree has no ``vision`` subtree, else none."""
    cfg = DB1Config(model=model.cfg, vocab=model.vocab)
    sd, _ = state_dict_from_jax(params_np, cfg)
    return load_into(model, sd)


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Load a torch/DeepSpeed checkpoint file's tensors, on the CPU in the
    file's dtypes (the copy into a model casts each once; the JAX
    package's function of this name makes f32 numpy copies first, the
    same values).

    Accepts either a raw ``state_dict`` file or a DeepSpeed engine state
    (``module`` key), e.g. ``<dir>/<tag>/mp_rank_00_model_states.pt``.
    """
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "module" in obj and isinstance(obj["module"], dict):
        obj = obj["module"]
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    out = {}
    for k, v in obj.items():
        if hasattr(v, "numel"):
            out[k.replace("module.", "", 1) if k.startswith("module.") else k] = v
    return out


def find_deepspeed_model_states(load_dir: str, tag: str) -> str:
    cand = os.path.join(load_dir, tag, MODEL_STATES)
    if os.path.exists(cand):
        return cand
    for root, _, files in os.walk(os.path.join(load_dir, tag)):
        for f in files:
            if f.endswith("model_states.pt"):
                return os.path.join(root, f)
    raise FileNotFoundError(f"no model_states.pt under {load_dir}/{tag}")


def state_dict_from_torch(sd: Mapping[str, torch.Tensor], cfg: DB1Config
                          ) -> Dict[str, torch.Tensor]:
    """Reference torch names -> the port's state dict, CPU tensors in the
    file's dtypes: the vocab rows padded with zeros and ``pos_emb.inv_freq``
    computed in f32, not read (the file holds it rounded to the
    checkpoint's dtype; the JAX converter does not read it either)."""
    layout = cfg.vocab.layout()
    out = {}
    for k, v in sd.items():
        if k == "pos_emb.inv_freq":
            v = torch.from_numpy(_inv_freq(cfg.model.n_embed))
        elif k in _VOCAB_ROWS:
            if v.shape[0] != layout.total_vocab_size:
                raise ValueError(f"{k}: {v.shape[0]} rows, expected "
                                 f"{layout.total_vocab_size}")
            v = torch.cat([v, v.new_zeros(
                (layout.padded_vocab_size - v.shape[0], v.shape[1]))])
        out[k] = v
    return out


def load_deepspeed_checkpoint(model: torch.nn.Module, path: str
                              ) -> List[str]:
    """Load a ``model_states.pt`` (``find_deepspeed_model_states``) into
    ``model`` (cast to the model's dtypes and device). Returns the names
    left at their init: the vision tower's when the file has none of it."""
    cfg = DB1Config(model=model.cfg, vocab=model.vocab)
    return load_into(model, state_dict_from_torch(
        load_torch_state_dict(path), cfg))


def state_dict_to_torch(sd: Mapping[str, torch.Tensor], cfg: DB1Config,
                        dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """A whole model's state dict -> the reference's tensors as the JAX
    package's ``invert_state_dict`` gives them, cast to ``dtype`` and
    copied to the CPU (the inverse of :func:`state_dict_from_torch`): the
    word embedding and an untied head cut to the real vocab rows, and
    ``pos_emb.inv_freq`` the analytic f32 buffer. The names are the
    port's, which are the reference's: the shared ``r_w_bias``/``r_r_bias``
    at the top and under every layer (under the layers only with
    ``untie_r``)."""
    total = cfg.vocab.layout().total_vocab_size
    out = {}
    for k, v in sd.items():
        if k == "pos_emb.inv_freq":
            v = torch.from_numpy(_inv_freq(cfg.model.n_embed))
        elif k in _VOCAB_ROWS:
            v = v[:total]
        # cast where the tensor lives, then a host copy of its own
        out[k] = v.detach().to(dtype).to("cpu", copy=True)
    return out


def _whole_state_dict(model: torch.nn.Module):
    """The whole model's state dict (collective under a mesh): a pipeline
    stage's layers gathered on stage 0 (parallel/pipeline.py
    ``gather_stages``; None on the later stages), then a tensor-parallel
    model's shards over its model group (parallel/mesh.py
    ``gather_state_dict``)."""
    if getattr(model, "pp", None) is not None:
        from bdm_db1_tpu_torch.parallel.pipeline import gather_stages

        model = gather_stages(model)
        if model is None:
            return None
    sd = model.state_dict()
    if getattr(model, "tp", None) is not None:
        sd = gather_state_dict(sd, model.tp, model.cfg)
    return sd


def save_deepspeed_checkpoint(model: torch.nn.Module, cfg: DB1Config,
                              load_dir: str, tag: str,
                              dtype: str = "float16") -> str:
    """Write ``<load_dir>/<tag>/mp_rank_00_model_states.pt`` in the
    reference's DeepSpeed engine layout, ``{"module": {name: tensor}}``,
    from ``model``'s weights (:func:`state_dict_to_torch`; ``dtype`` any
    torch dtype's name), as bdm_db1_tpu/train/convert.py's function of
    this name writes a JAX param tree. Returns the file's path.

    The port's model always holds the vision tower, so the file always
    has it. A sharded model is gathered first: every rank calls this, the
    collectives run over its mesh, world rank 0 (stage 0, model rank 0,
    data rank 0) writes, and every rank returns once the file is
    written. A model with int8 decode weights raises ``ValueError``
    (neither the reference nor the JAX package has an int8 layout)."""
    if model.cfg.decode_weight_dtype:
        raise ValueError(
            f"decode_weight_dtype={model.cfg.decode_weight_dtype!r}: the "
            "DeepSpeed layout has no int8 weights; export the model with "
            "decode_weight_dtype=''")
    sd = _whole_state_dict(model)
    path = os.path.join(load_dir, tag, MODEL_STATES)
    if rank_and_world()[0] == 0:
        module = state_dict_to_torch(sd, cfg, getattr(torch, dtype))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        torch.save({"module": module}, path)
    barrier()
    return path


def main(argv=None) -> None:
    """CLI: convert a DeepSpeed checkpoint into step 0 of a port checkpoint
    directory (train/checkpoint.py), as the JAX package's convert CLI
    writes an orbax one::

        python -m bdm_db1_tpu_torch.train.convert --load-dir /ckpts \\
            --tag db1_870task_checkpoint --output /ckpts_port \\
            [--config cfg.json]

    ``--config`` defaults to ``db1_1p2b()``. The step holds the model's
    tensors in f32 (the JAX converter's master params) and the client
    state ``{"source": "<load-dir>/<tag>", "iteration": 0}``; the
    evaluation driver's ``load_params`` and ``load_model`` read it. A file
    without the vision tower (a model that never saw images) gets the
    tower at a seeded init of its own: ``VisionEmbedding.reset_parameters``
    from a CPU generator seeded by ``eval.seed``, since a port checkpoint
    holds every model tensor.

    A file conversion on the host: it reads, casts and writes tensors on
    the CPU, and no step of it computes on a device, so it needs no card.
    """
    import argparse

    ap = argparse.ArgumentParser("convert")
    ap.add_argument("--load-dir", required=True)
    ap.add_argument("--tag", default="db1_870task_checkpoint")
    ap.add_argument("--output", required=True)
    ap.add_argument("--config", default=None,
                    help="DB1Config json; default: the 1.2B flagship")
    args = ap.parse_args(argv)

    from bdm_db1_tpu_torch.core.config import db1_1p2b
    from bdm_db1_tpu_torch.models.transformer_xl import TransformerXL
    from bdm_db1_tpu_torch.train.checkpoint import CheckpointManager
    from bdm_db1_tpu_torch.train.step import TrainState

    cfg = DB1Config.from_json(args.config) if args.config else db1_1p2b()
    cfg.model.param_dtype = "float32"
    sd = state_dict_from_torch(load_torch_state_dict(
        find_deepspeed_model_states(args.load_dir, args.tag)), cfg)
    # every tensor is overwritten, so no random init
    model = torch.nn.utils.skip_init(
        TransformerXL, cfg.model, cfg.vocab, vision=cfg.vision,
        device="cpu", generator=torch.Generator())
    model.share_r_bias()
    left = set(load_into(model, sd))
    del sd
    if left:
        model.vision_encoder.reset_parameters(
            torch.Generator().manual_seed(cfg.eval.seed))
        print(f"the file has no vision tower: {len(left)} tensors at their "
              f"init, seed {cfg.eval.seed}")
    n = sum(p.numel() for k, p in model.named_parameters() if k not in left)
    print(f"converted {n:,} parameters")

    mgr = CheckpointManager(args.output)
    mgr.save(0, TrainState(step=0, model=model, optimizer=None),
             client_state={"source": f"{args.load_dir}/{args.tag}",
                           "iteration": 0})
    mgr.wait()
    mgr.close()
    print(f"wrote port checkpoint to {mgr.step_dir(0)}")


if __name__ == "__main__":
    main()
