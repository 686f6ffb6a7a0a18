"""Typed configuration tree of the port (copy of the parts of
bdm_db1_tpu/core/config.py that the RL-evaluation decode path reads).

``ModelConfig`` keeps every field of the JAX package's, with the same
defaults, so the two configs compare field for field; the decode-path
switches keep their meaning on the GPU (``decode_flash``: "auto" runs the
CUDA kernels for 1 <= q <= 32 on CUDA tensors, "on" forces the kernel route,
whose CPU form is the kernels' plain versions, "off" the plain ring branch).
``DataConfig`` carries the data fields the validation-loss path reads
(sequence length, split, prompt sampling); ``MeshConfig``, ``TrainConfig``
and the JSON/CLI round trip belong to later slices.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

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
    # speculative decode: not ported yet (raises NotImplementedError)
    decode_speculative: bool = False
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
    # fields of eval entry points that later slices port
    ic_vqa_num_samples: int = 64
    ic_vqa_batch_size: int = 8
    baselines_path: Optional[str] = None
    score_threshold: float = 0.5
    sharded_decode: bool = False
    # geometry-bucket padding: not ported yet (raises NotImplementedError)
    decode_obs_buckets: bool = True


@dataclass
class DB1Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    vocab: VocabConfig = field(default_factory=VocabConfig)
    vision: VisionConfig = field(default_factory=VisionConfig)
    data: DataConfig = field(default_factory=DataConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)


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

