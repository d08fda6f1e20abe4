"""Print a registered module's default YAML (liteasr_tpu/prompt.py; reference:
liteasr/prompt.py:10-27), over the port's registries.

Usage: ``python -m liteasr_tpu_torch.prompt model.U2``
"""

import argparse
from typing import List, Optional

import yaml

from liteasr_tpu_torch.config.core import _node_to_dict
from liteasr_tpu_torch.criterions import _REGISTRY as CRITERIONS
from liteasr_tpu_torch.models import _REGISTRY as MODELS
from liteasr_tpu_torch.optims import _REGISTRY as OPTIMIZERS
from liteasr_tpu_torch.tasks import _REGISTRY as TASKS

# group -> {option: its config dataclass}
GROUPS = {
    "model": MODELS.dataclasses,
    "task": TASKS.dataclasses,
    "optimizer": OPTIMIZERS.dataclasses,
    "criterion": CRITERIONS.dataclasses,
}


def main(argv: Optional[List[str]] = None):
    parser = argparse.ArgumentParser()
    parser.add_argument("option", type=str,
                        help="<group>.<option> e.g. task.asr")
    args = parser.parse_args(argv)
    group, option = args.option.split(".")

    if group not in GROUPS:
        raise ValueError(f"{group} is not a module")
    registry = GROUPS[group]
    if option not in registry:
        raise ValueError(
            f"unknown {group} '{option}' (known: {sorted(registry)})")
    node = _node_to_dict(registry[option])
    node["name"] = option
    print(yaml.safe_dump(node, sort_keys=False))


if __name__ == "__main__":
    main()
