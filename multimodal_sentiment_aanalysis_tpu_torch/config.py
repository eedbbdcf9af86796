"""Constants and helpers shared with the JAX package's ``config.py``."""

from __future__ import annotations

from typing import Any

# MAHNOB-HCI subject ids of the 24 subjects the reference keeps
DEFAULT_SUBJECT_LISTS = [
    1, 2, 4, 5, 6, 7, 8, 10, 11, 13, 14, 17, 18, 19, 20, 21, 22, 23, 24,
    26, 27, 28, 29, 30,
]


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
