"""Python-file model configs (the port's copy of
``peanut_tpu.core.config_file``; mmcv ``Config.fromfile`` parity).

A config file runs in a namespace of its own; ``_base_`` chains resolve
(later files override earlier ones, dicts merge recursively, a dict with
``_delete_=True`` replaces the subtree) into a plain nested dict that the
registries' builders take.  The files under ``configs/`` are the JAX
package's; this loader gives the dicts its loader gives.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Dict

DELETE_KEY = "_delete_"
BASE_KEY = "_base_"


def _exec_file(path: str) -> Dict[str, Any]:
    ns: Dict[str, Any] = {}
    with open(path) as f:
        code = compile(f.read(), path, "exec")
    exec(code, ns)
    return {k: v for k, v in ns.items()
            if not k.startswith("__") and not callable(v)
            and not isinstance(v, type(os))}


def merge_dict(base: Dict, override: Dict) -> Dict:
    """Recursive merge with mmcv semantics (``_delete_`` replaces
    subtrees)."""
    out = copy.deepcopy(base)
    for k, v in override.items():
        if isinstance(v, dict) and v.pop(DELETE_KEY, False):
            out[k] = copy.deepcopy(v)
        elif isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merge_dict(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def load_config(path: str) -> Dict[str, Any]:
    """Load a python config file, resolving ``_base_`` inheritance."""
    path = os.path.abspath(path)
    cfg = _exec_file(path)
    bases = cfg.pop(BASE_KEY, [])
    if isinstance(bases, str):
        bases = [bases]
    merged: Dict[str, Any] = {}
    for b in bases:
        merged = merge_dict(merged, load_config(
            os.path.join(os.path.dirname(path), b)))
    return merge_dict(merged, cfg)



def dump_config(cfg: Dict[str, Any], path: str) -> None:
    """Write a config dict out as a python file that ``load_config``
    reads back into the same dict (one ``key = value`` line a top-level
    key, the value as ``pprint`` writes it)."""
    import pprint

    with open(path, "w") as f:
        for k, v in cfg.items():
            f.write(f"{k} = {pprint.pformat(v, width=88)}\n")
