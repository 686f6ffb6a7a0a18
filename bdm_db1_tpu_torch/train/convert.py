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
"""

from __future__ import annotations

import os
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

from bdm_db1_tpu_torch.core.config import DB1Config
from bdm_db1_tpu_torch.parallel.mesh import shard_state_dict, stage_state_dict

VISION_KEY = "vision"
VISION_PREFIX = "vision_encoder."
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


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().float().numpy()
    return np.asarray(x, dtype=np.float32)


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Load a torch/DeepSpeed checkpoint file into numpy (f32).

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
            out[k.replace("module.", "", 1) if k.startswith("module.") else k] = _np(v)
    return out


def find_deepspeed_model_states(load_dir: str, tag: str) -> str:
    cand = os.path.join(load_dir, tag, "mp_rank_00_model_states.pt")
    if os.path.exists(cand):
        return cand
    for root, _, files in os.walk(os.path.join(load_dir, tag)):
        for f in files:
            if f.endswith("model_states.pt"):
                return os.path.join(root, f)
    raise FileNotFoundError(f"no model_states.pt under {load_dir}/{tag}")


def state_dict_from_torch(sd: Mapping[str, np.ndarray], cfg: DB1Config
                          ) -> Dict[str, torch.Tensor]:
    """Reference torch names -> the port's state dict as f32 CPU tensors:
    the vocab rows padded with zeros and ``pos_emb.inv_freq`` computed, not
    read (the file holds it rounded to the checkpoint's dtype; the JAX
    converter does not read it either)."""
    layout = cfg.vocab.layout()
    out = {}
    for k, v in sd.items():
        v = (_inv_freq(cfg.model.n_embed) if k == "pos_emb.inv_freq"
             else np.asarray(v, np.float32))
        if k in ("word_embedding.weight", "lm_head.weight"):
            if v.shape[0] != layout.total_vocab_size:
                raise ValueError(f"{k}: {v.shape[0]} rows, expected "
                                 f"{layout.total_vocab_size}")
            v = np.concatenate([v, np.zeros(
                (layout.padded_vocab_size - v.shape[0], v.shape[1]),
                np.float32)], 0)
        out[k] = torch.from_numpy(np.ascontiguousarray(v))
    return out


def load_deepspeed_checkpoint(model: torch.nn.Module, path: str
                              ) -> List[str]:
    """Load a ``model_states.pt`` (``find_deepspeed_model_states``) into
    ``model`` (cast to the model's dtypes and device). Returns the names
    left at their init: the vision tower's when the file has none of it."""
    cfg = DB1Config(model=model.cfg, vocab=model.vocab)
    return load_into(model, state_dict_from_torch(
        load_torch_state_dict(path), cfg))
