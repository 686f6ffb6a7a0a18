"""Typed configuration tree of the port (copy of the parts of
bdm_db1_tpu/core/config.py that the RL-evaluation decode path reads).

``ModelConfig`` keeps every field of the JAX package's, with the same
defaults, so the two configs compare field for field; the decode-path
switches keep their meaning on the GPU (``decode_flash``: "auto" runs the
CUDA kernels for 1 <= q <= 32 on CUDA tensors, "on" forces the kernel route,
whose CPU form is the kernels' plain versions, "off" the plain ring branch).
``DataConfig`` carries the data fields the validation-loss path reads
(sequence length, split, prompt sampling); ``OptimizerConfig`` and
``TrainConfig`` those of the train step and the trainer, every field kept
(``TrainConfig.prng_impl`` names a JAX generator kind: torch has one kind,
so the port keeps the field for the round trip and ignores it).
``MeshConfig`` is kept field for field; the port runs on one card, so
``mesh.multihost`` True raises in the entry points that read it.
``DB1Config`` has the JAX package's JSON and CLI round trip
(``to_dict``/``to_json``/``from_dict``/``from_json``/``parser``/
``from_cli``): a JSON written by either package loads in both.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import typing
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

from bdm_db1_tpu_torch.core.vocab import VocabLayout


@dataclass
class VocabConfig:
    text_vocab_size: int = 32_000
    num_discrete_values: int = 1_024
    num_continuous_bin: int = 1_024
    overlap_with_text: bool = True
    discretize_mu: float = 100.0
    discretize_M: float = 256.0

    def layout(self) -> VocabLayout:
        return VocabLayout(
            text_vocab_size=self.text_vocab_size,
            num_discrete_values=self.num_discrete_values,
            num_continuous_bin=self.num_continuous_bin,
            overlap_with_text=self.overlap_with_text,
        )


@dataclass
class VisionConfig:
    num_input_channels: int = 3
    patch_size: int = 16
    position_vocab_size: int = 128
    hidden_dropout_prob: float = 0.5
    # IC/VQA input resolution (reference vit_dataset.py transform stacks)
    image_size: int = 224


@dataclass
class ModelConfig:
    n_embed: int = 768
    n_position: int = 1024
    n_layer: int = 12
    n_head: int = 12
    n_inner: Optional[int] = None
    activation_fn: str = "gelu"
    layer_norm_epsilon: float = 1e-5
    # dropout family (reference: src/config.py:108-168)
    resid_pdrop: float = 0.1
    attn_pdrop: float = 0.0
    embd_pdrop: float = 0.1
    drop: float = 0.1
    dropattn: float = 0.0
    # training-path switches (a later slice of the port reads them; kept so
    # the two ModelConfigs compare field for field)
    dropout_impl: str = "flax"
    # TransformerXL
    mem_len: int = 0
    pre_lnorm: bool = False
    same_length: bool = True
    untie_r: bool = False
    clamp_len: Optional[int] = None  # defaults to n_position
    use_deepnorm: bool = False
    share_input_output_embedding: bool = True
    # RL local-timestep embedding vocab: ids 1..512 for obs+separator, 0 = action
    rl_timestep_vocab_size: int = 513
    attention_impl: str = "auto"
    remat: bool = False
    remat_policy: str = "full"
    sequence_sharded_activations: bool = False
    # compute dtype of activations and matmuls; attention scores, softmax
    # and logits stay f32
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # "" = ring cache in the compute dtype; "int8" = int8 values with
    # per-(slot, head) f32 scales, read by the CUDA kernels K6/K7
    decode_cache_dtype: str = ""
    # "" = trunk weights in param_dtype; "int8" = qkv/o/FF matrices int8
    # with per-output-channel scales through the K9 kernel; "int8a8" = the
    # same weights through the W8A8 int8 product (activations per row)
    decode_weight_dtype: str = ""
    # ring-decode attention route: "auto" = the CUDA kernels
    # (ops/flash_ring_decode.py) for 1 <= q <= 32 when the cache is one they
    # take, else the plain ring branch; "on" = the kernel route for
    # 1 <= q <= 32 whatever the device (the plain kernel versions on the
    # CPU); "off" = always the plain ring branch
    decode_flash: str = "auto"
    # speculative (Jacobi) greedy action decode (eval/decode.py): the
    # previous step's action block guesses this step's, verified as a
    # query-only tail of the prime and by verify forwards until the
    # greedy fixed point; the actions equal the sequential decode's.
    # Ignored for one-token (discrete) actions and without same_length
    decode_speculative: bool = False
    # adaptive speculation: each episode or cohort switches between the
    # speculative and the classic decode by its verify rounds' average
    decode_spec_adaptive: bool = False
    # a variant of the TPU prime kernel; the CUDA prime kernel computes the
    # same function for both values
    decode_prime_compact: bool = False

    @property
    def d_head(self) -> int:
        assert self.n_embed % self.n_head == 0
        return self.n_embed // self.n_head

    @property
    def d_inner(self) -> int:
        return self.n_inner if self.n_inner is not None else 4 * self.n_embed

    @property
    def effective_clamp_len(self) -> int:
        return self.clamp_len if self.clamp_len is not None else self.n_position


@dataclass
class MeshConfig:
    """The device mesh of the JAX package: DP = ``data`` axis, TP =
    ``model`` axis, PP (> 1) a ``pipe`` axis. The port lays the same mesh
    over its process world, a card a process (parallel/mesh.py): data
    parallelism over the data group, tensor parallelism over the model
    group, the GPipe pipeline (parallel/pipeline.py) over the pipe
    group."""

    data_parallel: int = -1  # -1: infer from device count / model_parallel
    model_parallel: int = 1
    pipeline_parallel: int = 1
    # pipeline microbatches per (grad-accum) micro step; -1 -> 2 * stages
    pipeline_microbatches: int = -1
    axis_names: Tuple[str, str] = ("data", "model")
    # multi-process bootstrap: None = auto-detect, True = force, False =
    # never
    multihost: Optional[bool] = None


@dataclass
class OptimizerConfig:
    optimizer: str = "adamw"
    lr: float = 1e-4
    min_lr: float = 1e-5
    adam_beta1: float = 0.9
    adam_beta2: float = 0.95
    adam_eps: float = 1e-8
    weight_decay: float = 0.1
    end_weight_decay: float = 0.1
    start_weight_decay: float = 0.1
    weight_decay_incr_style: str = "constant"
    clip_grad: float = 1.0
    adam_mu_dtype: Optional[str] = None  # e.g. "bfloat16": moments in bf16
    adam_nu_dtype: Optional[str] = None  # the same for the second moment
    fused: bool = False  # one elementwise pass (train/step.py FusedAdamW)
    lr_decay_style: str = "cosine"
    lr_warmup_iters: int = 0
    lr_warmup_fraction: Optional[float] = None
    lr_decay_iters: Optional[int] = None


@dataclass
class TrainConfig:
    train_iters: int = 10_000
    global_batch_size: int = 512
    micro_batch_size: int = 4
    seed: int = 1234
    log_interval: int = 10
    eval_interval: int = 1000
    eval_iters: int = 10
    save_interval: int = 1000
    # checkpoints (train/checkpoint.py), metrics.jsonl and, for
    # evaluate_rl, results.output
    save_dir: Optional[str] = None
    load_dir: Optional[str] = None
    ckpt_tag: str = "latest_model"
    tensorboard_dir: Optional[str] = None
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    # loss in fp32; grads accumulated in fp32
    grad_accum_dtype: str = "float32"
    # a JAX generator kind, ignored by the port (one torch.Generator kind)
    prng_impl: str = "rbg"


@dataclass
class DataConfig:
    # (weight, prefix, type) triples, reference --data-path semantics
    data_path: Tuple[str, ...] = ()
    split: str = "90,5,5"
    seq_length: int = 1024
    rl_dataset_cache_dir: Optional[str] = None
    use_prompt: bool = True
    prompt_ratio: float = 0.5
    prompt_prob: float = 0.25
    prompt_at_final_transition_prob: float = 0.5
    prompt_strategy: str = "stochastic_subseq;moving_prompt"
    num_workers: int = 2
    tokenizer_save_path: Optional[str] = None
    # few-shot RL finetuning: each RL train split draws from the first N
    # trajectories only
    num_rl_fewshot_episodes: Optional[int] = None


@dataclass
class EvalConfig:
    env_names: Tuple[str, ...] = ()
    task_suite_names: Tuple[str, ...] = ()
    num_trials: int = 5
    max_step_size: Optional[int] = None
    strict_length: bool = True
    minimal_expert_data: bool = False
    use_prompt: bool = True
    prompt_strategy: str = "stochastic_subseq;moving_prompt"
    seed: int = 100
    # lockstep batching: decode up to batch_size same-geometry episodes per
    # device call; ``interleave`` cohorts are live at once, each holding its
    # own ring KV cache
    batched: bool = True
    batch_size: int = 24
    interleave: int = 2
    # pretrain's in-training caption and VQA metrics (eval/evaluate_ic.py,
    # eval/evaluate_vqa.py): samples per valid set (0: off), batch
    ic_vqa_num_samples: int = 64
    ic_vqa_batch_size: int = 8
    baselines_path: Optional[str] = None
    score_threshold: float = 0.5
    sharded_decode: bool = False
    # geometry buckets: evaluate_rl pads primes to DEFAULT_OBS_BUCKETS
    # widths (eval/decode.py)
    decode_obs_buckets: bool = True


@dataclass
class DB1Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    vocab: VocabConfig = field(default_factory=VocabConfig)
    vision: VisionConfig = field(default_factory=VisionConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)

    # ---- serialization ---------------------------------------------------
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)

    @classmethod
    def from_dict(cls, d: dict) -> "DB1Config":
        return _from_dict(cls, d)

    @classmethod
    def from_json(cls, path: str) -> "DB1Config":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    # ---- CLI ---------------------------------------------------------------
    @classmethod
    def parser(cls) -> argparse.ArgumentParser:
        p = argparse.ArgumentParser("bdm-db1-tpu-torch")
        p.add_argument("--config", type=str, default=None,
                       help="JSON config file")
        _add_dataclass_args(p, cls, prefix="")
        return p

    @classmethod
    def from_cli(cls, argv=None) -> "DB1Config":
        args = cls.parser().parse_args(argv)
        cfg = cls.from_json(args.config) if args.config else cls()
        _apply_overrides(cfg, vars(args))
        return cfg


def db1_1p2b(**model_overrides) -> DB1Config:
    """The 1.2B flagship (reference: scripts/evaluate/evaluate_rl_1.2B.sh:16-86)."""
    cfg = DB1Config()
    kw = dict(
        n_embed=2048, n_position=1024, n_layer=24, n_head=16, n_inner=8192,
        activation_fn="geglu", mem_len=1024, pre_lnorm=False,
        same_length=True, untie_r=False, share_input_output_embedding=True,
    )
    kw.update(model_overrides)
    cfg.model = ModelConfig(**kw)
    return cfg


def db1_tiny(**model_overrides) -> DB1Config:
    """A test-scale config with the same structural choices as the flagship."""
    cfg = DB1Config()
    cfg.vocab = VocabConfig(text_vocab_size=256, num_discrete_values=64,
                            num_continuous_bin=64)
    kw = dict(
        n_embed=64, n_position=64, n_layer=2, n_head=4, n_inner=256,
        activation_fn="geglu", mem_len=32, pre_lnorm=False, same_length=True,
        untie_r=False, share_input_output_embedding=True,
    )
    kw.update(model_overrides)
    cfg.model = ModelConfig(**kw)
    cfg.data.seq_length = 64
    return cfg



# ---- generic dataclass <-> CLI/JSON plumbing --------------------------------

def _is_dc(t) -> bool:
    return dataclasses.is_dataclass(t) and isinstance(t, type)


def _from_dict(cls, d: dict):
    """Nested dicts -> nested dataclasses; keys the class does not have
    are dropped, lists become tuples."""
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        t = _resolve_type(cls, f)
        if isinstance(v, dict) and _is_dc(t):
            kwargs[f.name] = _from_dict(t, v)
        elif isinstance(v, list):
            kwargs[f.name] = tuple(v)
        else:
            kwargs[f.name] = v
    return cls(**kwargs)


def _resolve_type(cls, f):
    # the annotations are strings under the future import
    t = f.type
    if isinstance(t, str):
        t = typing.get_type_hints(cls).get(f.name, Any)
    return t


def _add_dataclass_args(p, cls, prefix: str):
    """One ``--section.field-name`` option per leaf field (``_`` -> ``-``);
    Optional[X] takes X, tuples take a list of strings, bools
    true/false/1/0."""
    for f in dataclasses.fields(cls):
        t = _resolve_type(cls, f)
        name = f"{prefix}{f.name}".replace("_", "-")
        if _is_dc(t):
            _add_dataclass_args(p, t, prefix=f"{prefix}{f.name}.")
            continue
        origin = typing.get_origin(t)
        if origin is typing.Union:  # Optional[X]
            inner = [a for a in typing.get_args(t) if a is not type(None)]
            t = inner[0] if inner else str
            origin = typing.get_origin(t)
        if t is bool:
            p.add_argument(f"--{name}", type=_str2bool, default=None)
        elif origin in (tuple, list):
            p.add_argument(f"--{name}", type=str, nargs="*", default=None)
        elif t in (int, float, str):
            p.add_argument(f"--{name}", type=t, default=None)


def _str2bool(x: str) -> bool:
    if x in ("True", "true", "1"):
        return True
    if x in ("False", "false", "0"):
        return False
    raise ValueError(x)


def _apply_overrides(cfg, flat: dict) -> None:
    """Set every parsed option that was given (not None) on ``cfg``."""
    for k, v in flat.items():
        if v is None or k == "config":
            continue
        obj = cfg
        parts = k.split(".")
        for part in parts[:-1]:
            obj = getattr(obj, part)
        leaf = parts[-1]
        if hasattr(obj, leaf):
            if isinstance(getattr(obj, leaf), tuple) and isinstance(v, list):
                v = tuple(v)
            setattr(obj, leaf, v)
