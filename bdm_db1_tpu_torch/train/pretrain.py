"""Pretraining driver (counterpart of bdm_db1_tpu/train/pretrain.py): how DB1
is trained on its multi-modal mixture.

Usage, on the card:

    python -m bdm_db1_tpu_torch.data.preprocess --input corpus.jsonl \
        --json-key text --output-prefix /data/corpus
    python -m bdm_db1_tpu_torch.train.pretrain --config cfg.json \
        --data.data-path 0.5 /data/corpus nlp 0.5 halfcheetah-medium-v2 rl \
        --data.rl-dataset-cache-dir /data/rl --train.train-iters 10000 \
        --train.save-dir /ckpts

Wires: config -> tokenizers -> dataset factory (indexed corpora as GPT
spans, RL trajectory caches through the "rl" and "rl_task_suite"
creators, COCO captions and VQA v2 through the "ic" and "vqa" creators of
data/vit_dataset.py, prefix "<image root>:<annotation json>[:<question
json>]") -> blended mixture -> per-modality groups -> stratified loader
-> model, optimizer and train step on the device -> ``Trainer`` (logging,
the eval hook: validation loss, RL rollouts and, with
``eval.ic_vqa_num_samples`` > 0, the caption and VQA metrics on the
unblended valid splits; checkpoints with resume).

Data parallelism: one process a card, started by a launcher, e.g. on the
cards of one host

    torchrun --nproc-per-node 8 -m bdm_db1_tpu_torch.train.pretrain ...

(``mesh.multihost`` None finds the launcher's variables, True insists on
them). Each rank's loader takes its shard of the global batch, the model
starts from rank 0's parameters, the train step sums the gradients over
the ranks (train/step.py) and checkpoints are saved collectively.

Tensor parallelism: ``--mesh.model-parallel 2`` (and optionally
``--model.sequence-sharded-activations true``) lays the world out as JAX's
(dp, tp) mesh, rank r at (r // tp, r % tp); the world must hold dp x tp
processes. Each rank holds its shard of the model (the seeded init's
slice), the loader shards by data rank, the RL rollouts and the caption
and VQA metrics of the eval hook run on data rank 0's model group (every
rank of it, with the same envs and seeds), and checkpoints hold whole
tensors:

    torchrun --nproc-per-node 8 -m bdm_db1_tpu_torch.train.pretrain \
        --mesh.model-parallel 2 ...

Pipeline parallelism: ``--mesh.pipeline-parallel 2`` lays the world out as
JAX's (dp, pp, tp) mesh, rank r at (d, s, t) with r = (d * pp + s) * tp +
t; the world must hold dp x pp x tp processes and pp must divide
``model.n_layer``. Stage s holds its share of the layers and the
replicated parameters (the seeded init's share), each micro-batch runs
the GPipe schedule of parallel/pipeline.py over ``mesh.pipeline_microbatches``
pipeline micro-batches (2 x pp when not positive), the loader shards by
data rank, and checkpoints hold whole tensors. The eval hook runs the
validation loss through the stages; for the RL rollouts and the caption
and VQA metrics the stages of data rank 0 send their layers to stage 0
(``gather_stages``, collective over each pipe group), whose model group
runs them on the whole model, with the same envs and seeds as one
process:

    torchrun --nproc-per-node 8 -m bdm_db1_tpu_torch.train.pretrain \
        --mesh.pipeline-parallel 2 [--mesh.model-parallel 2] ...
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from bdm_db1_tpu_torch.core.config import DB1Config
from bdm_db1_tpu_torch.core.logging import (
    MetricLogger, print_rank_0,
)
from bdm_db1_tpu_torch.data.blendable import BlendableDataset
from bdm_db1_tpu_torch.data.dataset_utils import (
    build_train_valid_test_datasets, get_datasets_weights_and_types,
    register_creator,
)
from bdm_db1_tpu_torch.data.rl_dataset import (
    RLTokenizerSuite, build_rl_dataset_from_cache, make_rl_creator,
)
from bdm_db1_tpu_torch.data.samplers import (
    RandomSampler, StratifiedGatoLoader, mixture_counts,
)
from bdm_db1_tpu_torch.data.vit_dataset import (
    make_ic_creator, make_vqa_creator,
)
from bdm_db1_tpu_torch.eval.envs import make_env
from bdm_db1_tpu_torch.eval.evaluate_ic import evaluate_ic
from bdm_db1_tpu_torch.eval.evaluate_vqa import evaluate_vqa
from bdm_db1_tpu_torch.eval.harness import evaluate_env
from bdm_db1_tpu_torch.eval.wrapper import TokenizedEnv
from bdm_db1_tpu_torch.models.transformer_xl import TransformerXL
from bdm_db1_tpu_torch.parallel.distributed import (
    broadcast_flat, default_backend, device_for_rank,
    maybe_initialize_distributed, rank_and_world, world_group,
)
from bdm_db1_tpu_torch.parallel.mesh import (
    PipelineParallel, TensorParallel, batch_sharding,
    check_pipeline_parallel, check_tensor_parallel, data_axis, make_mesh,
    pipeline_parallel, tensor_parallel,
)
from bdm_db1_tpu_torch.parallel.pipeline import gather_stages
from bdm_db1_tpu_torch.tokenizers.scalar import ScalarTokenizer
from bdm_db1_tpu_torch.tokenizers.text import build_text_tokenizer
from bdm_db1_tpu_torch.train.step import init_train_state, make_train_step
from bdm_db1_tpu_torch.train.trainer import (
    Trainer, _check_device, evaluate_loss,
)


def build_tokenizer_suite(cfg: DB1Config) -> RLTokenizerSuite:
    """The tokenizers of ``cfg``: the vocab layout, the scalar tokenizer
    and the text tokenizer (``data.tokenizer_save_path``, then
    ``$DB1_TOKENIZER_PATH``, then bytes)."""
    return RLTokenizerSuite(
        cfg.vocab.layout(),
        ScalarTokenizer(cfg.vocab.num_continuous_bin,
                        cfg.vocab.discretize_mu, cfg.vocab.discretize_M),
        build_text_tokenizer(cfg.data.tokenizer_save_path,
                             cfg.vocab.text_vocab_size),
        vision_patch_size=cfg.vision.patch_size,
    )


def build_loader(cfg: DB1Config, datasets_by_modality: Dict[str, object],
                 weights: Dict[str, float],
                 tp=None) -> StratifiedGatoLoader:
    """This process's loader (one card a process): {modality: {field:
    [accum, micro, ...]}} with the fixed ``mixture_counts`` of the weights
    over ``train.micro_batch_size``, accum = global batch / (micro x
    data-parallel processes), one ``RandomSampler`` a group from the start
    of the stream (seed ``train.seed``, sharded by the data rank: the
    ``torch.distributed`` rank when a process group is up, ``tp.data_rank``
    under tensor or pipeline parallelism (``tp`` a ``TensorParallel`` or
    ``PipelineParallel``), whose model group and pipeline read the same
    rows) and ``data.num_workers`` threads."""
    proc, n_proc = batch_sharding(tp)
    micro = cfg.train.micro_batch_size
    counts = mixture_counts(weights, micro)
    accum = max(1, cfg.train.global_batch_size // (micro * n_proc))
    samplers = {
        m: RandomSampler(len(d), 0, counts[m], proc, n_proc,
                         seed=cfg.train.seed)
        for m, d in datasets_by_modality.items()
    }
    return StratifiedGatoLoader(
        datasets_by_modality, samplers, counts, accum,
        num_threads=cfg.data.num_workers)


def group_by_modality(train_ds):
    """({group: dataset}, {group: weight}): the stratified loader wants
    one dataset per shape-homogeneous group, so a blended mixture splits
    by the modality of a probe sample of each part (RL with images rides
    as ``rl_img<T>x<H>x<W>x<C>``); parts of one group are blended again in
    index mode."""
    def group_key(probe) -> str:
        m = probe.get("modality", "rl")
        if m == "rl" and "images" in probe:
            shape = "x".join(str(s) for s in probe["images"].shape)
            return f"rl_img{shape}"
        return m

    if hasattr(train_ds, "datasets"):
        groups: Dict[str, list] = {}
        for d, w in zip(train_ds.datasets, train_ds.weights):
            groups.setdefault(group_key(d[0]), []).append((d, float(w)))
        out, weights = {}, {}
        for m, pairs in groups.items():
            if len(pairs) == 1:
                out[m] = pairs[0][0]
            else:
                out[m] = BlendableDataset(
                    [p[0] for p in pairs], [p[1] for p in pairs],
                    mode="index", size=sum(len(p[0]) for p in pairs))
            weights[m] = sum(p[1] for p in pairs)
        return out, weights
    m = group_key(train_ds[0])
    return {m: train_ds}, {m: 1.0}


def check_mesh(cfg: DB1Config) -> None:
    """A ``mesh.model_parallel`` that cannot split the model, or a
    ``mesh.pipeline_parallel`` that does not divide ``model.n_layer``,
    raises ``ValueError`` naming the field (parallel/mesh.py
    ``check_tensor_parallel``, ``check_pipeline_parallel``)."""
    m = cfg.mesh
    if m.model_parallel > 1:
        check_tensor_parallel(cfg.model, cfg.vocab.layout().padded_vocab_size,
                              m.model_parallel)
    if m.pipeline_parallel > 1:
        check_pipeline_parallel(cfg.model.n_layer, m.pipeline_parallel)


def check_world(cfg: DB1Config) -> None:
    """The world must hold dp x pp x tp processes (one card a process):
    ``mesh.data_parallel``, when positive, times ``mesh.pipeline_parallel``
    and ``mesh.model_parallel``; otherwise a multiple of pp x tp."""
    m = cfg.mesh
    dp, pp, tp = (m.data_parallel, max(1, m.pipeline_parallel),
                  max(1, m.model_parallel))
    world = rank_and_world()[1]
    if dp > 0 and dp * pp * tp != world:
        raise ValueError(f"mesh.data_parallel is {dp}, "
                         f"mesh.pipeline_parallel {pp} and "
                         f"mesh.model_parallel {tp}, but the process world "
                         f"has {world} processes, not dp x pp x tp")
    if world % (pp * tp):
        raise ValueError(f"mesh.pipeline_parallel x mesh.model_parallel is "
                         f"{pp} x {tp} but the process world has {world} "
                         "processes")


def mesh_parallel(cfg: DB1Config, device
                  ) -> Tuple[Optional[TensorParallel],
                             Optional[PipelineParallel]]:
    """(the :class:`TensorParallel` of this process when
    ``mesh.model_parallel`` > 1, its :class:`PipelineParallel` when
    ``mesh.pipeline_parallel`` > 1), each None otherwise, on the world's
    mesh."""
    m = cfg.mesh
    if m.model_parallel <= 1 and m.pipeline_parallel <= 1:
        return None, None
    mesh = make_mesh(m, torch.device(device).type)
    tp = (tensor_parallel(mesh, cfg.model.sequence_sharded_activations)
          if m.model_parallel > 1 else None)
    pp = (pipeline_parallel(mesh, m.pipeline_microbatches)
          if m.pipeline_parallel > 1 else None)
    return tp, pp


def main(cfg: Optional[DB1Config] = None, device="cuda") -> None:
    """Train ``cfg`` (default: the command line, ``DB1Config.from_cli``)
    on ``device`` (``"cuda"``: this rank's card), in the process world
    of the launcher when there is one (``mesh.multihost``)."""
    cfg = cfg or DB1Config.from_cli()
    check_mesh(cfg)
    maybe_initialize_distributed(force=cfg.mesh.multihost,
                                 backend=default_backend(device))
    check_world(cfg)
    dev = _check_device(device_for_rank(device))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    in_world = world_group() is not None
    tp, pp = mesh_parallel(cfg, dev)
    axis = data_axis(tp, pp)
    data_rank = batch_sharding(axis)[0]
    print_rank_0(f"device: {dev}"
                 + (f" ({torch.cuda.get_device_name(dev)})"
                    if dev.type == "cuda" else "")
                 + (f", {rank_and_world()[1]} processes" if in_world
                    else ""))

    tok = build_tokenizer_suite(cfg)
    if cfg.data.rl_dataset_cache_dir:
        rl_creator, suite_creator = make_rl_creator(
            tok, cfg.data.rl_dataset_cache_dir,
            num_fewshot_episodes=cfg.data.num_rl_fewshot_episodes,
            use_prompt=cfg.data.use_prompt,
            prompt_ratio=cfg.data.prompt_ratio,
            prompt_prob=cfg.data.prompt_prob,
            prompt_at_final_transition_prob=(
                cfg.data.prompt_at_final_transition_prob),
            prompt_strategy=cfg.data.prompt_strategy.split(";")[0])
        register_creator("rl", rl_creator)
        register_creator("rl_task_suite", suite_creator)
    _, _, types = get_datasets_weights_and_types(cfg.data.data_path)
    if {"ic", "vqa"} & set(types):
        kw = dict(n_position=cfg.model.n_position,
                  image_size=cfg.vision.image_size,
                  patch_size=cfg.vision.patch_size,
                  eos_token_id=tok.text_tokenizer.eos_token_id)
        register_creator("ic", make_ic_creator(**kw))
        register_creator("vqa", make_vqa_creator(**kw))

    n_train = cfg.train.train_iters * cfg.train.global_batch_size
    train_ds, valid_ds, _, valid_no_blend = build_train_valid_test_datasets(
        cfg.data.data_path, cfg.data.split, cfg.data.seq_length,
        (n_train, cfg.train.eval_iters * cfg.train.global_batch_size, 0),
        cfg.train.seed, cfg.train.global_batch_size,
        cache_dir=cfg.data.rl_dataset_cache_dir)

    datasets, weights = group_by_modality(train_ds)
    loader = build_loader(cfg, datasets, weights, axis)
    try:
        # the JAX driver draws one batch to initialise its parameters; the
        # port draws it too, so both train on the same stream
        example = next(loader)
        print_rank_0("batch groups: " + ", ".join(
            f"{m} {list(f['label'].shape)}" for m, f in example.items()))

        model = TransformerXL(
            cfg.model, cfg.vocab, vision=cfg.vision, device=dev,
            generator=torch.Generator(device=dev).manual_seed(cfg.train.seed),
            tp=tp, pp=pp)
        if axis is not None:  # every replica starts from data rank 0's share
            broadcast_flat(list(model.state_dict().values()),
                           src=dist.get_global_rank(axis.data_group, 0),
                           group=axis.data_group)
        elif in_world:      # every rank starts from rank 0's weights
            broadcast_flat(list(model.state_dict().values()), src=0)
        state = init_train_state(model, cfg.train.optimizer,
                                 cfg.train.train_iters)
        n_params = sum(p.numel() for p in model.parameters())
        print_rank_0(f"model parameters: {n_params:,}")

        def eval_fn(state, iteration):
            """The validation loss over ``train.eval_iters`` batches, RL
            rollouts of ``eval.env_names`` and the caption and VQA metrics
            on the training weights, the model in eval mode meanwhile. A
            pipeline stage runs the validation loss through the stages;
            for the rollouts and the metrics the stages of data rank 0
            send their layers to stage 0 (collective over each pipe
            group), whose model group runs them on the whole model, while
            the other stages go on to the barrier after the hook."""
            state.model.eval()
            try:
                return _eval(state)
            finally:
                state.model.train()

        def _eval(state):
            out = {}
            if valid_ds is not None:
                vd, vw = group_by_modality(valid_ds)
                vloader = build_loader(cfg, vd, vw, axis)
                try:
                    batches = [next(vloader)
                               for _ in range(cfg.train.eval_iters)]
                finally:
                    vloader.stop()
                out["loss"] = evaluate_loss(state.model, batches, device=dev)
            n_icvqa = cfg.eval.ic_vqa_num_samples
            model = state.model
            if pp is not None and data_rank == 0 and (
                    cfg.eval.env_names or (n_icvqa and valid_no_blend)):
                model = gather_stages(state.model)   # collective
                if model is None:                   # a later stage
                    return out
            if cfg.eval.env_names and data_rank == 0:
                for name in cfg.eval.env_names:
                    def make_tenv(n=name):
                        ds = build_rl_dataset_from_cache(
                            n, cfg.data.rl_dataset_cache_dir,
                            cfg.model.n_position, tok,
                            use_prompt=cfg.eval.use_prompt)
                        return TokenizedEnv(make_env(n), ds)

                    res = evaluate_env(
                        model, make_tenv,
                        num_trials=cfg.eval.num_trials, seed=cfg.eval.seed,
                        max_step_size=cfg.eval.max_step_size)
                    out[f"return/{name}"] = res["return_mean"]
                    out[f"length/{name}"] = res["length_mean"]
            # the in-training caption and VQA metrics on the unblended
            # valid splits (reference: train.py:24-25, 173-207)
            if n_icvqa and valid_no_blend and data_rank == 0:
                layout = cfg.vocab.layout()
                eos = tok.text_tokenizer.eos_token_id
                for i, ds in enumerate(valid_no_blend.get("ic", [])):
                    metrics = evaluate_ic(
                        model, ds, layout, eos, num_samples=n_icvqa,
                        batch_size=cfg.eval.ic_vqa_batch_size)
                    for k, v in metrics.items():
                        out[f"ic{i}/{k}"] = v
                for i, ds in enumerate(valid_no_blend.get("vqa", [])):
                    metrics = evaluate_vqa(
                        model, ds, layout, eos,
                        text_tokenizer=tok.text_tokenizer,
                        num_samples=n_icvqa,
                        batch_size=cfg.eval.ic_vqa_batch_size)
                    for k, v in metrics.items():
                        out[f"vqa{i}/{k}"] = v
            return out

        logger = MetricLogger(cfg.train.save_dir, cfg.train.tensorboard_dir)
        trainer = Trainer(cfg, model, make_train_step(model), state, loader,
                          eval_fn=eval_fn, logger=logger)
        trainer.train()
    finally:
        loader.stop()
    print_rank_0("training complete")


if __name__ == "__main__":
    main()
