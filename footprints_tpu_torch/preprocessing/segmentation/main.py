"""Segmentation pipeline entry point (counterpart of
footprints_tpu/preprocessing/segmentation/main.py):

  python -m footprints_tpu_torch.preprocessing.segmentation.main --mode train ...
  python -m footprints_tpu_torch.preprocessing.segmentation.main --mode inference ...

Runs on the card unless ``--device cpu`` is given.  Data-parallel training
over N cards of one host (or N processes on the CPU with ``--device cpu``):

  python -m torch.distributed.run --standalone --nproc_per_node=N \
      -m footprints_tpu_torch.preprocessing.segmentation.main --mode train ...
"""

from .options import Options
from ...parallel import shutdown


def main(argv=None):
    """Parse ``argv``, then train the Segmentor (returns the Trainer) or
    dump the ground_seg tree (returns the Tester)."""
    opts = Options().parse(argv)
    if opts.mode == "train":
        print("In training mode!")
        from .trainer import Trainer

        trainer = Trainer(opts)
        trainer.train()
        return trainer
    print("In inference mode!")
    from .inference import Tester

    tester = Tester(opts)
    tester.test()
    return tester


if __name__ == "__main__":
    try:
        main()
    finally:
        shutdown()
