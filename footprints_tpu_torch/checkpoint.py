"""Reader of the JAX package's flat ``checkpoint.npz`` (this port's own copy
of footprints_tpu/train/checkpoint.py:load_checkpoint).

Keys are '/'-joined pytree paths; list indices are plain path segments
beside a ``<path>/__list__`` (or ``__tuple__``) length entry; ``None`` leaves
are listed in ``__none_keys__``; empty dicts are ``<path>/__empty_dict__``.
"""

import numpy as np


def load_checkpoint(path):
    """Read a checkpoint back into a nested pytree of numpy arrays."""
    with np.load(path, allow_pickle=False) as data:
        none_keys = (set(data["__none_keys__"].tolist())
                     if "__none_keys__" in data else set())
        flat = {k: data[k] for k in data.files if k != "__none_keys__"}

    root = {}
    lists = {}  # path -> (kind, length)
    for key in list(flat):
        if key.endswith("__list__") or key.endswith("__tuple__"):
            base, _, tag = key.rpartition("/")
            lists[base] = ("list" if tag == "__list__" else "tuple", int(flat.pop(key)))

    # materialise a node for every sequence path: an empty list or tuple has
    # no element entries, so it would otherwise never appear in the tree
    for base in lists:
        node = root
        for part in (base.split("/") if base else []):
            node = node.setdefault(part, {})

    for key, val in flat.items():
        if key.endswith("/__empty_dict__"):
            key = key[: -len("/__empty_dict__")]
            val = {}
        elif key in none_keys:
            val = None
        parts = key.split("/") if key else []
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        if not parts:
            return val  # scalar or None root
        node[parts[-1]] = val

    def fix(node, path):
        if isinstance(node, dict):
            if path in lists:
                kind, n = lists[path]
                seq = [fix(node[str(i)], f"{path}/{i}" if path else str(i))
                       for i in range(n)]
                return seq if kind == "list" else tuple(seq)
            return {k: fix(v, f"{path}/{k}" if path else k) for k, v in node.items()}
        return node

    return fix(root, "")
