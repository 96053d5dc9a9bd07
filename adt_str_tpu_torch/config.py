"""Config system: YAML load + deep-merge + typed dataclasses.

Port of `adt_str_tpu/config.py` (its own copy: this package imports nothing
from the JAX package). Same semantics: the default config deep-merged under
the experiment YAML, `${oc.env:VAR}` / `${VAR}` substitution, YAML 1.2
floats (`8e-4` is a float), unknown keys and sections dropped.

Only the sections the ported slices use are typed (`shared`, `tokenizer`,
`model`, `synthetiser`, `TrainDatasetConfig` as `train_data`,
`EvalDatasetConfig` as `eval_data`, `training`, `logging`, `checkpoint`,
`experiment`, `inference`, `serving`, `mesh`; `clap_config` as
`ClapConfig` through `make_dataclass_from`); every other section stays
readable in `FrameworkConfig.raw`. The YAML is read by the port's own reader
(`parse_yaml`), never by PyYAML: the machine with the card has none.
"""

from __future__ import annotations

import dataclasses
import os
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

_ENV_OC = re.compile(r"\$\{oc\.env:([^}]+)\}")
_ENV_PLAIN = re.compile(r"\$\{([^}]+)\}")

# The repo's default config, shared with the JAX package.
DEFAULT_CONFIG_PATH = Path(__file__).resolve().parent.parent / "configs" / "config_default.yaml"


def substitute_env_vars(content: str) -> str:
    """`${oc.env:VAR}` / `${VAR}` -> value of $VAR (left untouched if unset)."""

    def _replace(match: re.Match) -> str:
        return os.getenv(match.group(1), match.group(0))

    content = _ENV_OC.sub(_replace, content)
    return _ENV_PLAIN.sub(_replace, content)


# Plain scalars, resolved as the JAX package's loader resolves them (PyYAML's
# SafeLoader with the YAML 1.2 float grammar added).
_NULLS = {"", "~", "null", "Null", "NULL"}
_BOOLS = {"true": True, "True": True, "TRUE": True, "false": False, "False": False, "FALSE": False}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9]*)")
_FLOAT = re.compile(r"[-+]?(?:[0-9]+\.[0-9]*(?:[eE][-+]?[0-9]+)?|\.[0-9]+(?:[eE][-+]?[0-9]+)?|[0-9]+[eE][-+]?[0-9]+)")
_INF_NAN = re.compile(r"[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)")
# Plain scalars that PyYAML (YAML 1.1) reads other than YAML 1.2 does, or as
# something other than a string or a number: yes/no/on/off, hex, octal and
# binary ints, sexagesimals, dates, merge keys.
_AMBIGUOUS = re.compile(
    r"yes|Yes|YES|no|No|NO|on|On|ON|off|Off|OFF|<<|="
    r"|[-+]?0[xXoObB][0-9a-fA-F_]+|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?"
    r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}(?:[Tt ].*)?"
)
# Numbers that _INT and _FLOAT do not take: a leading zero (octal in YAML
# 1.1, decimal in 1.2) and underscores between digits (PyYAML drops them)
_NUMBERISH = re.compile(
    r"[-+]?(?:0[0-9_]+|[1-9][0-9_]*_[0-9_]*(?:\.[0-9_]*)?(?:[eE][-+]?[0-9]+)?"
    r"|[0-9]*\.[0-9_]*_[0-9_]*(?:[eE][-+]?[0-9]+)?)"
)
_KEY_LINE = re.compile(r"(?:([A-Za-z_][A-Za-z0-9_.\-]*)|'([^']*)'|\"([^\"\\\\]*)\"):(?: +(.*))?")
_COMMENT = re.compile(r"\s#")
_REFUSED_START = {"&": "an anchor", "*": "an alias", "!": "a tag", "|": "a block scalar", ">": "a block scalar",
                  "{": "a flow mapping", "[": "a nested flow sequence", "]": "a stray `]`", "}": "a stray `}`",
                  ",": "a stray `,`", "@": "a reserved indicator", "`": "a reserved indicator", "%": "a directive",
                  "?": "a complex key", "-": "a block sequence", ":": "an empty key"}


def _plain(text: str, where: str):
    if text in _NULLS:
        return None
    if text in _BOOLS:
        return _BOOLS[text]
    if _INT.fullmatch(text):
        return int(text)
    if _FLOAT.fullmatch(text):
        return float(text)
    if _INF_NAN.fullmatch(text):
        return float(text.replace(".", "", 1))
    if _AMBIGUOUS.fullmatch(text) or _NUMBERISH.fullmatch(text):
        raise ValueError(f"{where}: {text!r} reads differently in YAML 1.1 and 1.2, or not as a string: quote it")
    if text[0] in _REFUSED_START and not (text[0] in "-?:" and len(text) > 1 and text[1] != " "):
        raise ValueError(f"{where}: {_REFUSED_START[text[0]]} is outside the YAML subset this reader takes")
    if ": " in text or text.endswith(":"):
        raise ValueError(f"{where}: a mapping inside a value is outside the YAML subset this reader takes")
    return text


def _quoted(text: str, where: str) -> tuple[str, str]:
    """A quoted scalar at the start of `text` -> (its value, the rest)."""
    quote, out, i = text[0], [], 1
    escapes = {"\\": "\\", '"': '"', "/": "/", "n": "\n", "t": "\t"}
    while i < len(text):
        c = text[i]
        if c == quote:
            if quote == "'" and text[i + 1 : i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), text[i + 1 :]
        if quote == '"' and c == "\\":
            esc = text[i + 1 : i + 2]
            if esc not in escapes:
                raise ValueError(f"{where}: the escape \\{esc} is outside the YAML subset this reader takes")
            out.append(escapes[esc])
            i += 2
            continue
        out.append(c)
        i += 1
    raise ValueError(f"{where}: a quoted scalar must end on its line")


def _strip_comment(text: str) -> str:
    """`text` up to a comment (a `#` after whitespace)."""
    m = _COMMENT.search(text)
    return (text if m is None else text[: m.start()]).rstrip()


def _scalar(text: str, where: str):
    if text[0] in "\"'":
        value, rest = _quoted(text, where)
        if rest[:1] not in ("", " ", "\t") or _strip_comment(rest).strip():
            raise ValueError(f"{where}: text after a quoted scalar")
        return value
    return _plain(_strip_comment(text), where)


def _value(text: str, where: str):
    """The value after `key: ` (not empty)."""
    if text[0] == "[":
        body = _strip_comment(text)
        if not body.endswith("]") or any(c in body[1:-1] for c in "[]{}"):
            raise ValueError(f"{where}: a flow sequence must be one line of scalars, `[a, b]`")
        inner = body[1:-1].strip()
        items = [item.strip() for item in inner.split(",")] if inner else []
        if any(not item for item in items):
            raise ValueError(f"{where}: an empty item in a flow sequence")
        return [_scalar(item, where) for item in items]
    return _scalar(text, where)


def parse_yaml(text: str, source: str = "<string>") -> dict:
    """The YAML subset of `configs/` -> a dict, as PyYAML with the YAML 1.2
    float grammar reads it: block mappings by indentation, `key: value`
    scalars (ints, YAML 1.2 floats, true/false, null, bare and quoted
    strings), sequences of scalars (one-line `[a, b]`, or `- a` lines as
    PyYAML writes them), comments and blank lines. Anything else (anchors,
    aliases, tags, block scalars, flow mappings, nested sequences, mappings
    in a sequence, multi-line scalars, a tab in the indentation, a duplicate
    key, a scalar that YAML 1.1 and 1.2 read differently) raises a
    ValueError naming `source` and the line: the reader never guesses."""
    root: dict = {}
    stack: list[list] = [[None, root]]  # [indent of the mapping's keys, mapping]
    open_key = None  # (indent, mapping, key) of a `key:` whose value may be a nested mapping
    for lineno, line in enumerate(text.splitlines(), 1):
        where = f"{source}:{lineno}"
        body = line.lstrip(" ")
        if not body.strip() or body.lstrip(" \t").startswith("#"):
            continue
        if body[0] == "\t":
            raise ValueError(f"{where}: a tab in the indentation")
        indent = len(line) - len(body)
        body = body.rstrip()
        entry = body == "-" or body.startswith("- ")
        if open_key is not None:
            parent_indent, parent, key = open_key
            open_key = None
            if entry and indent >= parent_indent:  # a block sequence, indented or not
                parent[key] = []
                stack.append([indent, parent[key]])
            elif indent > parent_indent:
                parent[key] = {}
                stack.append([indent, parent[key]])
        while stack[-1][0] is not None and indent < stack[-1][0]:
            stack.pop()
        if isinstance(stack[-1][1], list) and not entry and indent == stack[-2][0]:
            stack.pop()  # the key after a sequence at its key's own indentation
        if stack[-1][0] is None:
            stack[-1][0] = indent
        if indent != stack[-1][0]:
            raise ValueError(f"{where}: the indentation matches no enclosing mapping (a multi-line scalar?)")
        if isinstance(stack[-1][1], list):
            item = body[1:].strip()
            if not entry or not item:
                raise ValueError(f"{where}: a block sequence holds `- scalar` items only")
            stack[-1][1].append(_scalar(item, where))
            continue
        if body.startswith(("---", "...")) or entry:
            raise ValueError(f"{where}: a block sequence outside a mapping value, or a document marker, is "
                             "outside the YAML subset this reader takes")
        m = _KEY_LINE.fullmatch(body)
        if m is None:
            raise ValueError(f"{where}: expected `key: value`")
        bare, rest = m.group(1), m.group(4)
        key = bare if bare is not None else m.group(2) if m.group(2) is not None else m.group(3)
        if bare is not None and not isinstance(_plain(bare, where), str):
            raise ValueError(f"{where}: the key {key!r} is not a string")
        mapping = stack[-1][1]
        if key in mapping:
            raise ValueError(f"{where}: duplicate key {key!r}")
        if rest is None or not rest.strip() or rest.lstrip().startswith("#"):
            mapping[key] = None
            open_key = (indent, mapping, key)
        else:
            mapping[key] = _value(rest.strip(), where)
    return root


def load_config_from_yaml(path: str | Path) -> dict:
    """Load a YAML file into a plain dict (env vars substituted first)."""
    with open(path, "r") as f:
        content = f.read()
    return parse_yaml(substitute_env_vars(content), str(path))


def deep_merge_dicts(base: dict, override: dict) -> dict:
    """Recursive dict merge, override wins; returns a new dict."""
    merged = dict(base)
    for key, value in (override or {}).items():
        if key in merged and isinstance(merged[key], dict) and isinstance(value, dict):
            merged[key] = deep_merge_dicts(merged[key], value)
        else:
            merged[key] = value
    return merged


def load_merged_config(experiment_path: str | Path, default_path: str | Path | None = None) -> dict:
    """Default-config + experiment-config merge."""
    default_path = Path(default_path) if default_path else DEFAULT_CONFIG_PATH
    base = load_config_from_yaml(default_path) if default_path.exists() else {}
    return deep_merge_dicts(base, load_config_from_yaml(experiment_path))


def make_dataclass_from(cls, *sections: dict):
    """Build dataclass `cls` from merged dict sections (later wins), dropping
    unknown keys."""
    names = {f.name for f in dataclasses.fields(cls)}
    merged: dict = {}
    for s in sections:
        merged.update(s or {})
    return cls(**{k: v for k, v in merged.items() if k in names})


@dataclass(frozen=True)
class SharedConfig:
    """Audio framing contract shared by every stage."""

    input_sec: float = 2.56
    time_res: float = 0.01
    win_length: int = 2048
    sample_rate: int = 24000

    @property
    def hop_length(self) -> int:
        return int(self.time_res * self.sample_rate)

    @property
    def chunk_samples(self) -> int:
        return int(self.input_sec * self.sample_rate)


@dataclass(frozen=True)
class TokenizerConfig:
    ADTOF_mapping: bool = False
    BOS_token: int = 2
    EOS_token: int = 3
    pad_token: int = 1
    silence_token: int = 0
    add_velocity: bool = True

    def __post_init__(self):
        # The loss ignore_index and EOS/PAD decode truncation are fixed to
        # PAD=1 (specials silence=0, PAD=1, BOS=2, EOS=3).
        if self.pad_token != 1:
            raise ValueError(
                "pad_token must be 1: the loss ignore_index and decode "
                "truncation are fixed to the vocab layout "
                "(specials silence=0, PAD=1, BOS=2, EOS=3)"
            )


@dataclass(frozen=True)
class ModelConfig(SharedConfig):
    enc_layers: int = 4
    dec_layers: int = 4
    nhead: int = 6
    d_query: int = 128
    dropout: float = 0.1
    tgt_vocab_size: int = 1400
    enc_lr: float = 1e-4
    dec_lr: float = 1e-4
    plain: bool = True
    n_mels: int = 128
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    max_positions: int = 2048  # sinusoidal PE table length
    # kernel flags: the port reads the JAX package's flag names, and each
    # selects the port's own kernel (K1 log-mel, K5 attention, K4 FFN)
    use_pallas_mel: bool = False
    use_flash_attention: bool = False
    use_pallas_ffn: bool = False
    remat: bool = False

    @property
    def d_model(self) -> int:
        return self.d_query * self.nhead

    @property
    def ffn_dim(self) -> int:
        return int(self.d_model * 4)


@dataclass(frozen=True)
class SynthConfig(SharedConfig):
    """The on-device drum synthesiser's knobs that the render and the bank
    load read (`adt_str_tpu/config.py:SynthConfig`); the dataset's velocity
    fields come with the dataset slice that reads them."""

    oneshot_path: str = ""  # the bank file is f"{oneshot_path}@{sample_rate}.hdf5"
    similarity_threshold: float = 0.8
    ADTOF_mapping: bool = False
    mixup_range: float = 0.8
    use_fx_prob: float = 0.3
    use_reverb_prob: float = 0.5
    use_limiter_prob: float = 0.5
    use_compression_prob: float = 0.5
    max_notes: int = 128  # notes per segment, padded and masked
    max_oneshot_sec: float = 2.56  # one-shot bank rows padded to this length


@dataclass(frozen=True)
class TrainDataConfig(SharedConfig):
    """The `TrainDatasetConfig` section: Lakh note shards or TMIDT audio
    shards and the host pipeline's knobs (`adt_str_tpu/config.py:TrainDataConfig`)."""

    dataset_path: str = ""
    empty_tokens_percentage: float = 0.05
    random_velocity_prob: float = 0.5
    dataset_name: str = "Lakh"
    partitions: Optional[list[str]] = None
    max_tokens: int = 512  # padded token length of an example
    shuffle_buffer: int = 8192
    prefetch: int = 2  # batches the prefetch thread keeps ready
    seed: int = 0
    # the unshuffled prefix held out of training epochs for the in-training
    # eval stream (0.0: the reference's behaviour, no holdout)
    holdout_fraction: float = 0.0


@dataclass(frozen=True)
class EvalDataConfig(SharedConfig):
    """The `EvalDatasetConfig` section: an ENST or MDB parquet shard and its
    filters (`adt_str_tpu/config.py:EvalDataConfig`)."""

    dataset_path: str = ""
    dataset_name: str = "ENST"
    drummers: Optional[list[int]] = None
    minus_one: bool = False
    splits: Optional[list[int]] = None
    demucs_separated: bool = False


@dataclass(frozen=True)
class ClapConfig(SharedConfig):
    """The `clap_config` section of `configs/preprocess/clap.yaml`: the local
    CLAP checkpoint directory, the encode batch and the two trees
    (`adt_str_tpu/config.py:ClapConfig`)."""

    model_name: str = "laion/clap-htsat-fused"
    batch_size: int = 32
    sample_pack_root: str = ""
    reference_root: str = ""


@dataclass
class InferenceConfig:
    checkpoint_path: Optional[str] = None
    batch_size: int = 8
    max_length: int = 1024
    beam_size: int = 5
    use_beam_search: bool = False
    output_path: str = "results/"
    max_samples: Optional[int] = None


@dataclass
class ServingConfig:
    """Online-serving engine knobs (`serve.py` / `serving/engine.py`); CLI
    flags on `serve.py` override YAML."""

    buckets: tuple = (1, 2, 4, 8, 16, 32, 64)
    max_wait_ms: float = 2.0
    max_length: Optional[int] = None  # None -> inference.max_length
    use_beam_search: bool = False
    beam_size: int = 5
    length_penalty: float = 1.0
    host: str = "127.0.0.1"
    port: int = 8321
    precompile: bool = True

    def __post_init__(self) -> None:
        self.buckets = tuple(int(b) for b in self.buckets)


@dataclass
class TrainingConfig:
    """The `training:` section (`adt_str_tpu/config.py:TrainingConfig`).
    `grad_allreduce_dtype` and `ddp_loss_weighting` set how the ranks of a
    data-parallel run reduce (`parallel/train_step.py`); in one process
    they change nothing."""

    batch_size: int = 64
    num_epochs: float = 1.0
    learning_rate: float = 1e-4
    min_learning_rate: Optional[float] = None
    warmup_ratio: float = 0.1
    weight_decay: float = 1e-5
    max_grad_norm: float = 1.0
    gradient_accumulation_steps: int = 1
    mixed_precision: str = "bf16"
    optim: str = "adamw"
    lr_scheduler_type: str = "cosine"
    eval_strategy: str = "no"
    max_dataloader_num_workers: int = 0
    max_steps: Optional[int] = None  # caps the analytic step count
    grad_allreduce_dtype: Optional[str] = None
    ddp_loss_weighting: bool = False
    # N > 0: a step whose gradients hold NaN/Inf leaves params and optimizer
    # state untouched, until N consecutive such steps let one through
    skip_nonfinite_updates: int = 0


@dataclass
class LoggingConfig:
    output_dir: str = "./outputs"
    logging_steps: int = 1
    save_every_n_steps: Optional[int] = None
    eval_every_n_steps: Optional[int] = None
    eval_batches: int = 8  # batches per in-training eval pass
    log_level: str = "INFO"
    profile_steps: Optional[list[int]] = None  # torch.profiler trace window (first, last step)


@dataclass
class CheckpointConfig:
    resume_from_checkpoint: Optional[str] = None
    auto_resume: bool = False
    max_checkpoints: Optional[int] = 3


@dataclass
class ExperimentConfig:
    seed: int = 42
    use_wandb: bool = False
    project_name: Optional[str] = None
    run_name: str = "default"


@dataclass
class MeshConfig:
    """The parallel layout. The ranks of a torchrun job form a data axis
    (-1: all the ranks the model axis leaves) by a tensor-parallel model
    axis (`parallel/mesh.py:make_mesh`); `fsdp` shards the parameters and
    the optimizer's moments over the data axis (`parallel/fsdp.py`)."""

    data_axis: int = -1  # -1: all remaining devices
    model_axis: int = 1
    fsdp: bool = False


@dataclass
class FrameworkConfig:
    """Typed view over the merged YAML dict (untyped sections stay in `raw`)."""

    shared: SharedConfig = field(default_factory=SharedConfig)
    tokenizer: TokenizerConfig = field(default_factory=TokenizerConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    synthetiser: Optional[SynthConfig] = None
    train_data: Optional[TrainDataConfig] = None
    eval_data: Optional[EvalDataConfig] = None
    training: TrainingConfig = field(default_factory=TrainingConfig)
    logging: LoggingConfig = field(default_factory=LoggingConfig)
    checkpoint: CheckpointConfig = field(default_factory=CheckpointConfig)
    experiment: ExperimentConfig = field(default_factory=ExperimentConfig)
    inference: InferenceConfig = field(default_factory=InferenceConfig)
    serving: ServingConfig = field(default_factory=ServingConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    raw: dict = field(default_factory=dict)

    @classmethod
    def from_dict(cls, cfg: dict) -> "FrameworkConfig":
        """`shared` is splatted into the model, synthetiser and eval dataset
        sections, the tokenizer's `ADTOF_mapping` is copied into the
        synthetiser's, and `training.learning_rate` into model
        enc_lr/dec_lr, as in the JAX package."""
        shared_d = cfg.get("shared", {}) or {}
        tok_d = cfg.get("tokenizer", {}) or {}
        training_d = cfg.get("training", {}) or {}
        model_d = dict(cfg.get("model", {}) or {})
        if training_d.get("learning_rate") is not None:
            lr = float(training_d["learning_rate"])
            model_d.setdefault("enc_lr", lr)
            model_d.setdefault("dec_lr", lr)

        synth = None
        if cfg.get("synthetiser"):
            synth_d = dict(cfg["synthetiser"])
            synth_d["ADTOF_mapping"] = tok_d.get("ADTOF_mapping", False)
            synth = make_dataclass_from(SynthConfig, synth_d, shared_d)

        train_data = None
        if cfg.get("TrainDatasetConfig"):
            train_data = make_dataclass_from(TrainDataConfig, cfg["TrainDatasetConfig"], shared_d)

        eval_data = None
        if cfg.get("EvalDatasetConfig"):
            eval_data = make_dataclass_from(EvalDataConfig, cfg["EvalDatasetConfig"], shared_d)

        def _coerce(cls_, section):
            d = {k: v for k, v in (cfg.get(section, {}) or {}).items() if v is not None}
            return make_dataclass_from(cls_, d)

        return cls(
            shared=make_dataclass_from(SharedConfig, shared_d),
            tokenizer=make_dataclass_from(TokenizerConfig, tok_d),
            model=make_dataclass_from(ModelConfig, model_d, shared_d),
            synthetiser=synth,
            train_data=train_data,
            eval_data=eval_data,
            training=_coerce(TrainingConfig, "training"),
            logging=_coerce(LoggingConfig, "logging"),
            checkpoint=_coerce(CheckpointConfig, "checkpoint"),
            experiment=_coerce(ExperimentConfig, "experiment"),
            inference=_coerce(InferenceConfig, "inference"),
            serving=_coerce(ServingConfig, "serving"),
            mesh=_coerce(MeshConfig, "mesh"),
            raw=cfg,
        )

    @classmethod
    def from_yaml(cls, experiment_path: str | Path, default_path: str | Path | None = None) -> "FrameworkConfig":
        return cls.from_dict(load_merged_config(experiment_path, default_path))
