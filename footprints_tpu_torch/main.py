"""Entry point: train (counterpart of footprints_tpu/main.py).

  python -m footprints_tpu_torch.main --mode train --training_dataset kitti ...

Runs on the card unless ``--device cpu`` is given.  ``--mode inference``
(the batch dump) is not ported yet.
"""

from .options import Options


def main(argv=None):
    """Parse ``argv`` and train; returns the TrainManager after training."""
    opts = Options().parse(argv)
    if opts.mode != "train":
        raise NotImplementedError(
            "--mode inference is not ported yet; it arrives with the "
            "batch-dump inference slice")
    from .train.trainer import TrainManager

    manager = TrainManager(opts)
    manager.train()
    return manager


if __name__ == "__main__":
    main()
