"""What the port's CLIs share: reading ``--config`` and refusing the JAX
package's options that the port does not run."""

import argparse
import json
from typing import Any, Dict, Mapping, Optional

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


def refuse_unported(parser: argparse.ArgumentParser, flags: Mapping[str, bool]) -> None:
    """``parser.error`` naming every flag in ``flags`` that is set (each
    name carrying its reason)."""
    asked = [name for name, on in flags.items() if on]
    if asked:
        parser.error(f"not ported: {'; '.join(asked)}")
