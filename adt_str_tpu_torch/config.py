"""Config system: YAML load + deep-merge + typed dataclasses.

Port of `adt_str_tpu/config.py` (its own copy: this package imports nothing
from the JAX package). Same semantics: the default config deep-merged under
the experiment YAML, `${oc.env:VAR}` / `${VAR}` substitution, YAML 1.2
floats (`8e-4` is a float), unknown keys and sections dropped.

Only the sections the ported slices use are typed (`shared`, `tokenizer`,
`model`, `inference`, `serving`); every other section stays readable in
`FrameworkConfig.raw`. PyYAML is imported inside `from_yaml` only: the
machine with the card has no PyYAML, and `FrameworkConfig.from_dict` needs
none.
"""

from __future__ import annotations

import dataclasses
import functools
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


@functools.cache
def _yaml12_loader():
    """SafeLoader with the YAML 1.2 float grammar: stock PyYAML (YAML 1.1)
    loads `8e-4` as a string, which the configs spell that way."""
    import yaml

    class Yaml12Loader(yaml.SafeLoader):
        pass

    Yaml12Loader.add_implicit_resolver(
        "tag:yaml.org,2002:float",
        re.compile(
            r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
            |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
            |[-+]?\.[0-9_]+(?:[eE][-+]?[0-9]+)?
            |[-+]?\.(?:inf|Inf|INF)
            |\.(?:nan|NaN|NAN))$""",
            re.X,
        ),
        list("-+0123456789."),
    )
    return Yaml12Loader


def load_config_from_yaml(path: str | Path) -> dict:
    """Load a YAML file into a plain dict (env vars substituted)."""
    import yaml

    with open(path, "r") as f:
        content = f.read()
    return yaml.load(substitute_env_vars(content), Loader=_yaml12_loader()) or {}


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
class FrameworkConfig:
    """Typed view over the merged YAML dict (untyped sections stay in `raw`)."""

    shared: SharedConfig = field(default_factory=SharedConfig)
    tokenizer: TokenizerConfig = field(default_factory=TokenizerConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    inference: InferenceConfig = field(default_factory=InferenceConfig)
    serving: ServingConfig = field(default_factory=ServingConfig)
    raw: dict = field(default_factory=dict)

    @classmethod
    def from_dict(cls, cfg: dict) -> "FrameworkConfig":
        """`shared` is splatted into the model section, and
        `training.learning_rate` is copied into model enc_lr/dec_lr, as in
        the JAX package."""
        shared_d = cfg.get("shared", {}) or {}
        training_d = cfg.get("training", {}) or {}
        model_d = dict(cfg.get("model", {}) or {})
        if training_d.get("learning_rate") is not None:
            lr = float(training_d["learning_rate"])
            model_d.setdefault("enc_lr", lr)
            model_d.setdefault("dec_lr", lr)

        def _coerce(cls_, section):
            d = {k: v for k, v in (cfg.get(section, {}) or {}).items() if v is not None}
            return make_dataclass_from(cls_, d)

        return cls(
            shared=make_dataclass_from(SharedConfig, shared_d),
            tokenizer=make_dataclass_from(TokenizerConfig, cfg.get("tokenizer", {}) or {}),
            model=make_dataclass_from(ModelConfig, model_d, shared_d),
            inference=_coerce(InferenceConfig, "inference"),
            serving=_coerce(ServingConfig, "serving"),
            raw=cfg,
        )

    @classmethod
    def from_yaml(cls, experiment_path: str | Path, default_path: str | Path | None = None) -> "FrameworkConfig":
        return cls.from_dict(load_merged_config(experiment_path, default_path))
