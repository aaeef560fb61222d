"""What the port's CLIs share: reading ``--config``."""

import json
from typing import Any, Dict, Optional

from tvqvae_tpu_torch.config import Config, load_yaml


def load_config_dict(path: str) -> Dict[str, Any]:
    """A config file in the reference schema: ``.json`` through ``json``,
    anything else as YAML (which needs PyYAML)."""
    if str(path).endswith(".json"):
        with open(path) as f:
            return json.load(f)
    return load_yaml(path)


def load_config(path: Optional[str]) -> Config:
    return Config.from_dict(load_config_dict(path)) if path else Config()
