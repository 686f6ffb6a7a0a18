"""RL evaluation driver (counterpart of bdm_db1_tpu/eval/evaluate_rl.py, the
system's primary entry point).

Usage, on the card:

    python -m bdm_db1_tpu_torch.eval.evaluate_rl --config cfg.json \
        --eval.env-names halfcheetah-medium-v2 ... \
        --train.load-dir /ckpts --train.ckpt-tag db1_870task_checkpoint

Builds the model on the device, loads its weights (:func:`load_params`),
shards the env list across processes, evaluates each env (the batched
lockstep decoder, or one episode at a time with ``eval.batched`` false;
primes padded to geometry-bucket widths with ``eval.decode_obs_buckets``,
the default) and writes one JSON record per env to
``<train.save_dir>/results.output``, then, with ``eval.baselines_path``,
the suite summary. Rank 0 writes: its own records as each env finishes,
then those of the other ranks once gathered, in rank order.

Several processes, a card each, split the envs round-robin:

    torchrun --nproc-per-node 8 -m bdm_db1_tpu_torch.eval.evaluate_rl ...

Sharded decode (``--eval.sharded-decode true --mesh.model-parallel 2``):
the world is JAX's (dp, tp) mesh, rank r at (r // tp, r % tp). Each rank
holds its tensor-parallel shard of the model (its heads' ring cache, the
kernels on them), the envs shard over the data ranks, the ranks of a
model group step the same envs with the same seeds, and the records are
gathered one copy a data group.

A checkpoint of the JAX package (orbax) is not read here: write it as a
DeepSpeed ``model_states.pt`` with the JAX package's
``bdm_db1_tpu.train.convert.save_deepspeed_checkpoint`` and point
``train.load_dir``/``train.ckpt_tag`` at that.

"""

from __future__ import annotations

import json
import os
from typing import List, Optional

import torch

from bdm_db1_tpu_torch.core.config import DB1Config
from bdm_db1_tpu_torch.core.logging import print_rank_0, process_index
from bdm_db1_tpu_torch.data.rl_dataset import build_rl_dataset_from_cache
from bdm_db1_tpu_torch.eval.decode import DecoderPool
from bdm_db1_tpu_torch.eval.envs import make_env
from bdm_db1_tpu_torch.eval.harness import (
    evaluate_env, evaluate_envs_lockstep, gather_records, shard_envs,
)
from bdm_db1_tpu_torch.eval.wrapper import TokenizedEnv
from bdm_db1_tpu_torch.models.transformer_xl import TransformerXL
from bdm_db1_tpu_torch.parallel.distributed import (
    default_backend, device_for_rank, maybe_initialize_distributed,
    world_group,
)
from bdm_db1_tpu_torch.parallel.mesh import (
    batch_sharding, make_mesh, tensor_parallel,
)
from bdm_db1_tpu_torch.train.checkpoint import (
    CheckpointManager, load_model, wait_for_saves,
)
from bdm_db1_tpu_torch.train.convert import (
    find_deepspeed_model_states, load_deepspeed_checkpoint,
)
from bdm_db1_tpu_torch.train.pretrain import (
    check_mesh, build_tokenizer_suite, check_world,
)

# what load_params read
FROM_DEEPSPEED, FROM_PORT, FROM_RANDOM = "deepspeed", "port", "random"


def suite_env_names(suite: str) -> List[str]:
    """Every env of a task suite (d4rl's ``ALL_ENVS``; needs d4rl)."""
    import importlib

    mod = importlib.import_module(f"d4rl.{suite}")
    return list(mod.ALL_ENVS)


def load_params(cfg: DB1Config, model: TransformerXL) -> str:
    """Load the weights into ``model``, in this order: a DeepSpeed
    checkpoint under ``train.load_dir/train.ckpt_tag``; else the latest
    step of a port checkpoint at ``train.load_dir`` (its model tensors
    only, cast to the model's dtype), after this process's saves in
    flight there; else a random init seeded by
    ``eval.seed``. Returns which: FROM_DEEPSPEED, FROM_PORT or
    FROM_RANDOM."""
    load_dir, tag = cfg.train.load_dir, cfg.train.ckpt_tag
    if load_dir:
        try:
            path = find_deepspeed_model_states(load_dir, tag)
        except FileNotFoundError:
            path = None
        if path is not None:
            print_rank_0(f"loading DeepSpeed checkpoint {path}")
            load_deepspeed_checkpoint(model, path)
            return FROM_DEEPSPEED
    if load_dir and os.path.isdir(load_dir):
        wait_for_saves(load_dir)
        mgr = CheckpointManager(load_dir)
        step = mgr.latest_step()
        if step is not None:
            load_model(model, mgr.step_dir(step))
            print_rank_0(f"restored port checkpoint step {step} from "
                         f"{mgr.directory}")
            return FROM_PORT
    print_rank_0("WARNING: no checkpoint found — evaluating random init")
    model.reset_parameters(
        torch.Generator(device=model.device).manual_seed(cfg.eval.seed))
    return FROM_RANDOM


def main(cfg: Optional[DB1Config] = None, device="cuda") -> List[dict]:
    """Evaluate ``cfg.eval.env_names`` (and the envs of
    ``cfg.eval.task_suite_names``) on ``device`` (``"cuda"``: this rank's
    card); returns the records of every process's shard in rank-major
    order, one per env (plus the suite summary with a baselines file, on
    rank 0). ``cfg`` defaults to the command line
    (``DB1Config.from_cli``)."""
    cfg = cfg or DB1Config.from_cli()
    if cfg.eval.sharded_decode:
        check_mesh(cfg)
    maybe_initialize_distributed(force=cfg.mesh.multihost,
                                 backend=default_backend(device))
    if cfg.eval.sharded_decode:
        check_world(cfg)
    dev = device_for_rank(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a CUDA device was asked for but torch.cuda.is_available() "
                "is false; pass device='cpu' to run on the CPU")
        torch.cuda.set_device(dev)
    tp = None
    if cfg.eval.sharded_decode and world_group() is not None:
        tp = tensor_parallel(make_mesh(cfg.mesh, dev.type))
        print_rank_0(f"sharded decode over a ({tp.data_size}, {tp.size}) "
                     "(data, model) mesh")

    model = TransformerXL(
        cfg.model, cfg.vocab, vision=cfg.vision, device=dev,
        generator=torch.Generator(device=dev).manual_seed(cfg.eval.seed),
        tp=tp)
    load_params(cfg, model)
    n_params = sum(p.numel() for p in model.parameters())
    print_rank_0(f"model parameters: {n_params:,}")

    env_names = list(cfg.eval.env_names)
    for suite in cfg.eval.task_suite_names:
        env_names.extend(suite_env_names(suite))
    print_rank_0(f"evaluating {len(env_names)} envs, "
                 f"{cfg.eval.num_trials} trials each")

    tok = build_tokenizer_suite(cfg)
    # the dataset (cache mmap + sample index) is read-only at eval time:
    # one instance per env, shared by its tokenized envs
    ds_cache = {}

    def make_tenv(name: str) -> TokenizedEnv:
        env = make_env(name)
        if name not in ds_cache:
            ds_cache[name] = build_rl_dataset_from_cache(
                name, cfg.data.rl_dataset_cache_dir, cfg.model.n_position,
                tok,
                use_prompt=cfg.eval.use_prompt,
                prompt_strategy=cfg.eval.prompt_strategy.split(";")[0],
            )
        return TokenizedEnv(
            env, ds_cache[name],
            eval_prompt_strategy=cfg.eval.prompt_strategy.split(";")[-1])

    pool = DecoderPool(model, pad_buckets=(
        "default" if cfg.eval.decode_obs_buckets else None))
    rank = process_index()
    out_path = None
    if cfg.train.save_dir and rank == 0:
        os.makedirs(cfg.train.save_dir, exist_ok=True)
        out_path = os.path.join(cfg.train.save_dir, "results.output")

    def emit(res: dict) -> None:
        """Rank 0 prints a record and appends it to results.output."""
        if rank == 0:
            print(json.dumps(res), flush=True)
            if out_path:
                with open(out_path, "a") as f:
                    f.write(json.dumps(res) + "\n")

    local_names = shard_envs(env_names, *batch_sharding(tp))
    if cfg.eval.batched:
        records = evaluate_envs_lockstep(
            model, local_names, make_tenv,
            num_trials=cfg.eval.num_trials, seed=cfg.eval.seed,
            batch_size=cfg.eval.batch_size, decoder_pool=pool,
            use_prompt=cfg.eval.use_prompt,
            strict_length=cfg.eval.strict_length,
            minimal_expert_data=cfg.eval.minimal_expert_data,
            max_step_size=cfg.eval.max_step_size,
            interleave=cfg.eval.interleave)
    else:
        records = (evaluate_env(
            model, lambda n=name: make_tenv(n), decoder_pool=pool,
            num_trials=cfg.eval.num_trials, seed=cfg.eval.seed,
            use_prompt=cfg.eval.use_prompt,
            strict_length=cfg.eval.strict_length,
            minimal_expert_data=cfg.eval.minimal_expert_data,
            max_step_size=cfg.eval.max_step_size) for name in local_names)
    local = []
    for res in records:     # rank 0's own records as each env finishes
        emit(res)
        local.append(res)
    results = gather_records(local, tp)
    for res in results[len(local):] if rank == 0 else ():
        emit(res)           # then the other ranks' shards, in rank order

    if cfg.eval.baselines_path and rank == 0:
        # suite headline: the fraction of tasks at or above the threshold
        # of the expert score
        from bdm_db1_tpu_torch.eval.aggregate import aggregate_results
        from bdm_db1_tpu_torch.eval.baselines import BaselineRegistry

        reg = BaselineRegistry.from_json(cfg.eval.baselines_path)
        summary = aggregate_results(results, reg.table,
                                    threshold=cfg.eval.score_threshold)
        results.append({"suite_summary": summary})
        emit(results[-1])
    return results


if __name__ == "__main__":
    main()
