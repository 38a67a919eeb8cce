"""Declarative eval-dataset configs (counterpart of
`visionllm_tpu/eval/configs.py`, after the reference's
visionllmv2/datasets/configs/**/*.py): small Python files assigning
`datasets = [...]` (registry-typed dataset dicts for
`data.build.build_dataset`), or JSON files with the same list. The port
ships its copy of the JAX package's matrix under
`visionllm_tpu_torch/configs/`, keyed "<family>/<name>" (e.g.
"det/coco_val"). A Python config is executed in an empty namespace: it
is code the user controls, as in the reference.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

CONFIG_ROOT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")


def load_eval_config(path_or_key: str) -> List[Dict]:
    """Returns the `datasets` list from a config file.

    Accepts an explicit .py/.json path, or a shipped key like
    "det/coco_val" resolved under visionllm_tpu_torch/configs/.
    """
    path = path_or_key
    if not os.path.exists(path):
        for ext in (".py", ".json"):
            cand = os.path.join(CONFIG_ROOT, path_or_key + ext)
            if os.path.exists(cand):
                path = cand
                break
        else:
            raise FileNotFoundError(
                f"no eval config at '{path_or_key}' (looked in "
                f"{CONFIG_ROOT})")
    if path.endswith(".json"):
        with open(path) as f:
            data = json.load(f)
        return data["datasets"] if isinstance(data, dict) else data
    ns: Dict = {}
    with open(path) as f:
        exec(compile(f.read(), path, "exec"), ns)     # noqa: S102
    if "datasets" not in ns:
        raise ValueError(f"{path} does not define `datasets`")
    return ns["datasets"]


def list_shipped_configs() -> List[str]:
    out = []
    for root, _, files in os.walk(CONFIG_ROOT):
        for f in files:
            if f.endswith((".py", ".json")) and not f.startswith("__"):
                rel = os.path.relpath(os.path.join(root, f), CONFIG_ROOT)
                out.append(os.path.splitext(rel)[0])
    return sorted(out)
