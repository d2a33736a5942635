"""Entry point: train or batch inference (counterpart of footprints_tpu/main.py).

  python -m footprints_tpu_torch.main --mode train --training_dataset kitti ...
  python -m footprints_tpu_torch.main --mode inference --load_path <dir> ...

Runs on the card unless ``--device cpu`` is given.  Data-parallel training
over N cards of one host (or N processes on the CPU with ``--device cpu``):

  python -m torch.distributed.run --standalone --nproc_per_node=N \
      -m footprints_tpu_torch.main --mode train ...
"""

from .options import Options
from .parallel import shutdown


def main(argv=None):
    """Parse ``argv`` and train or dump the test split; returns the
    TrainManager or the InferenceManager after its run."""
    opts = Options().parse(argv)
    if opts.mode == "train":
        from .train.trainer import TrainManager

        manager = TrainManager(opts)
        manager.train()
    else:
        from .eval.inference import InferenceManager

        manager = InferenceManager(opts)
        manager.run()
    return manager


if __name__ == "__main__":
    try:
        main()
    finally:
        shutdown()
