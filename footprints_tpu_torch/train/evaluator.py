"""Loss accumulation across steps, on the device (counterpart of
footprints_tpu/train/evaluator.py).  The per-step loss dicts stay device
scalars; nothing syncs until ``get_averaged_losses`` at log cadence."""

import collections

import numpy as np
import torch


class Evaluator:
    def __init__(self):
        self._tracked = {"train": collections.defaultdict(list),
                         "val": collections.defaultdict(list)}

    def accumulate(self, losses, mode="train"):
        """Record one step's loss dict (device scalars; no sync)."""
        for key, val in losses.items():
            self._tracked[mode][key].append(val)

    def get_averaged_losses(self, mode="train", reset=True):
        """Average the tracked losses into Python floats: one device->host
        copy for all of them (this is the sync point)."""
        tracked = {k: v for k, v in self._tracked[mode].items() if v}
        out = {k: float("nan") for k in self._tracked[mode]}
        if tracked:
            host = torch.cat([torch.stack(v) for v in tracked.values()]).cpu().numpy()
            ends = np.cumsum([len(v) for v in tracked.values()])
            out.update({k: float(np.mean(vals)) for k, vals
                        in zip(tracked, np.split(host, ends[:-1]))})
        if reset:
            self._tracked[mode] = collections.defaultdict(list)
        return out
