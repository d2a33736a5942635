"""Segmentation pipeline entry point (counterpart of
footprints_tpu/preprocessing/segmentation/main.py):

  python -m footprints_tpu_torch.preprocessing.segmentation.main --mode inference ...

Runs on the card unless ``--device cpu`` is given.  ``--mode train``
arrives with the segmentation-training slice.
"""

from .options import Options


def main(argv=None):
    """Parse ``argv`` and dump the ground_seg tree; returns the Tester."""
    opts = Options().parse(argv)
    if opts.mode == "train":
        raise NotImplementedError(
            "segmentation --mode train is not ported yet; it arrives with the "
            "segmentation-training slice")
    print("In inference mode!")
    from .inference import Tester

    tester = Tester(opts)
    tester.test()
    return tester


if __name__ == "__main__":
    main()
