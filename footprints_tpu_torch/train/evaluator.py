"""Loss accumulation across steps, on the device (counterpart of
footprints_tpu/train/evaluator.py).  The per-step loss dicts stay device
scalars; nothing syncs until ``get_averaged_losses`` at log cadence, which
under data parallelism also averages them over the ranks (one all-reduce
of one small vector)."""

import collections

import numpy as np
import torch

from ..parallel.mesh import all_reduce_mean


class Evaluator:
    def __init__(self, mesh=None):
        self.mesh = mesh
        self._tracked = {"train": collections.defaultdict(list),
                         "val": collections.defaultdict(list)}

    def accumulate(self, losses, mode="train"):
        """Record one step's loss dict (device scalars; no sync)."""
        for key, val in losses.items():
            self._tracked[mode][key].append(val)

    def get_averaged_losses(self, mode="train", reset=True):
        """Average the tracked losses into Python floats: one device->host
        copy for all of them (this is the sync point).  With a distributed
        mesh every rank calls it at the same step, and each value is the
        mean of the ranks' means (one all-reduce of the host vector)."""
        tracked = {k: v for k, v in self._tracked[mode].items() if v}
        out = {k: float("nan") for k in self._tracked[mode]}
        if tracked:
            host = torch.cat([torch.stack(v) for v in tracked.values()]).cpu().numpy()
            ends = np.cumsum([len(v) for v in tracked.values()])
            means = [float(np.mean(vals)) for vals in np.split(host, ends[:-1])]
            if self.mesh is not None:
                means = all_reduce_mean(self.mesh, torch.tensor(means, dtype=torch.float64))
                means = means.tolist()
            out.update(zip(tracked, means))
        if reset:
            self._tracked[mode] = collections.defaultdict(list)
        return out
