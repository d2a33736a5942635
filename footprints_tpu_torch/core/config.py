"""Config and small file helpers: the yaml paths file and split lists
(counterpart of footprints_tpu/core/config.py).  PyYAML is imported inside
``load_config``, so the package imports on a host without it."""


def load_config(config_path: str) -> dict:
    """Load the dataset-paths yaml (see paths.yaml at the repo root)."""
    import yaml

    with open(config_path) as f:
        return yaml.safe_load(f)


def readlines(filename: str) -> list:
    """Read a text file into a list of stripped lines."""
    with open(filename) as f:
        return f.read().splitlines()
