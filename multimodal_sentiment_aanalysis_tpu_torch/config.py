"""Configuration: the JAX package's ``config.py`` without its import of yaml.

The reference's single-YAML schema (reference ``config/config.yaml:1-39``)
as typed dataclasses with the JAX package's keys and defaults, key for key,
so ``flatten_config(Config())`` gives the same history-CSV columns in both
packages. ``load_config(path)`` reads the same YAML; it imports PyYAML only
when called, so nothing else here needs it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any

# MAHNOB-HCI subject ids of the 24 subjects the reference keeps
DEFAULT_SUBJECT_LISTS = [
    1, 2, 4, 5, 6, 7, 8, 10, 11, 13, 14, 17, 18, 19, 20, 21, 22, 23, 24,
    26, 27, 28, 29, 30,
]


class _DictAccess:
    """Reference code reads config like ``config["data"]["HCI"]["ex_nums"]``;
    every config dataclass supports that item access."""

    def __getitem__(self, key: str):
        return getattr(self, key)


@dataclass
class HCIDataConfig(_DictAccess):
    """Dataset-layout keys (reference config/config.yaml:18-27)."""

    data_path: str = "HCI_DATA/hci_data.pkl"
    subject_lists: list[int] = field(default_factory=lambda: list(DEFAULT_SUBJECT_LISTS))
    modalities: list[str] = field(default_factory=lambda: ["eeg", "eye", "pps"])
    input_size: list[int] = field(default_factory=lambda: [960, 38, 230])
    input_dim: int = 585
    label_type: str = "arousal"
    num_workers: int = 4  # kept for YAML compatibility; the data is device-resident
    ch_nums: int = 32
    ex_nums: int = 20


@dataclass
class DataConfig(_DictAccess):
    name: str = "HCI"
    HCI: HCIDataConfig = field(default_factory=HCIDataConfig)


@dataclass
class TrainingConfig(_DictAccess):
    """Reference config/config.yaml:3-13."""

    ex_name: str = "HCI two modality fusion"
    batch_size: int = 64
    epochs: int = 300
    learning_rate: float = 1e-4
    weight_decay: float = 2e-3
    optimizer: str = "adam"
    loss_function: str = "cross_entropy"
    dependent: bool = True
    n_folds: int = 10
    using_modalities: list[str] = field(default_factory=lambda: ["eeg", "eye", "pps"])


@dataclass
class LoggingConfig(_DictAccess):
    log_dir: str = "logs"
    model_dir: str = "outputs"
    save_best_only: bool = True


@dataclass
class DeviceConfig(_DictAccess):
    """The JAX package's device keys, kept so that a config and its history
    columns are the same in both packages; the port reads none of them."""

    mesh_shape: list[int] = field(default_factory=lambda: [1])
    mesh_axes: list[str] = field(default_factory=lambda: ["data"])
    gpu: bool = True
    gpu_ids: list[int] = field(default_factory=lambda: [0])


@dataclass
class Config(_DictAccess):
    model: Any = None
    training: TrainingConfig = field(default_factory=TrainingConfig)
    data: DataConfig = field(default_factory=DataConfig)
    logging: LoggingConfig = field(default_factory=LoggingConfig)
    device: DeviceConfig = field(default_factory=DeviceConfig)
    seed: int = 42
    num_classes: int = 3

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


_SECTIONS = {"training": TrainingConfig, "logging": LoggingConfig, "device": DeviceConfig}


def _from_dict(cls, data: dict):
    """``cls`` from the keys of ``data`` it has (others are ignored)."""
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in data.items() if k in names})


def load_config(config_path: str | None = None) -> Config:
    """Load a YAML config with the reference's schema into a typed
    :class:`Config` (reference ``main.py:12-16``); missing keys take their
    defaults, so reference YAML files load unchanged."""
    if config_path is None:
        return Config()
    import yaml  # only here: nothing else in the port reads YAML

    with open(config_path, "r", encoding="utf-8") as f:
        raw = yaml.safe_load(f) or {}
    cfg = Config()
    for key, cls in _SECTIONS.items():
        if raw.get(key):
            setattr(cfg, key, _from_dict(cls, raw[key]))
    if raw.get("data"):
        data_raw = dict(raw["data"])
        hci_raw = data_raw.pop("HCI", None)
        cfg.data = _from_dict(DataConfig, data_raw)
        if hci_raw:
            cfg.data.HCI = _from_dict(HCIDataConfig, hci_raw)
    for key in ("seed", "num_classes"):
        if key in raw:
            setattr(cfg, key, raw[key])
    return cfg


def flatten_config(cfg: Any, parent_key: str = "") -> dict:
    """Flatten a nested config (a dict, or anything with ``to_dict()``) into
    dotted keys: nested dicts become ``a.b`` keys and lists comma-joined
    strings (JAX ``flatten_config``, reference ``common/utils.py:259-272``).
    Used by the experiment-history CSV appender."""
    if hasattr(cfg, "to_dict"):
        cfg = cfg.to_dict()
    items: list[tuple[str, Any]] = []
    for key, value in cfg.items():
        new_key = f"{parent_key}.{key}" if parent_key else key
        if isinstance(value, dict):
            items.extend(flatten_config(value, new_key).items())
        elif isinstance(value, list):
            items.append((new_key, ",".join(str(v) for v in value)))
        else:
            items.append((new_key, value))
    return dict(items)
