"""Writer and reader of the JAX package's flat ``checkpoint.npz`` (this
port's own copy of footprints_tpu/train/checkpoint.py), so a checkpoint
written by either package loads in the other.

Keys are '/'-joined pytree paths; list indices are plain path segments
beside a ``<path>/__list__`` (or ``__tuple__``) length entry; ``None`` leaves
are listed in ``__none_keys__``; empty dicts are ``<path>/__empty_dict__``.
The pytree is ``{params, state, opt_state, step}`` in the JAX layout
(convert.py builds it from the port's modules and optimizer).
"""

import os

import numpy as np

_NONE_SENTINEL = "__none__"
_RESERVED = ("__list__", "__tuple__", "__empty_dict__", "__none_keys__")


def _flatten(tree, prefix, out):
    if tree is None:
        out[prefix] = _NONE_SENTINEL
    elif isinstance(tree, dict):
        if not tree:
            out[prefix + "/__empty_dict__"] = np.zeros(0)
        for k, v in tree.items():
            if "/" in str(k) or str(k) in _RESERVED:
                raise ValueError(f"checkpoint key {k!r} is reserved or holds '/'")
            _flatten(v, f"{prefix}/{k}" if prefix else str(k), out)
    elif isinstance(tree, (list, tuple)):
        tag = "__list__" if isinstance(tree, list) else "__tuple__"
        out[f"{prefix}/{tag}" if prefix else tag] = np.asarray(len(tree))
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}/{i}" if prefix else str(i), out)
    else:
        out[prefix] = np.asarray(tree)


def save_checkpoint(path, train_state):
    """Write a pytree of numpy arrays to ``path`` (a .npz file), atomically."""
    flat = {}
    _flatten(train_state, "", flat)
    arrays = {k: (np.asarray(0) if isinstance(v, str) else v)
              for k, v in flat.items()}
    arrays["__none_keys__"] = np.asarray(
        [k for k, v in flat.items() if isinstance(v, str)])
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


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
