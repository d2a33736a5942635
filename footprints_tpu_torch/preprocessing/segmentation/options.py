"""Segmentation-pipeline CLI options (counterpart of
footprints_tpu/preprocessing/segmentation/options.py): the JAX package's
flags that ``--mode inference`` reads, plus ``--device``."""

import argparse


class Options:
    def __init__(self):
        self.options = None
        self.parser = argparse.ArgumentParser()
        p = self.parser

        p.add_argument("--mode", type=str, choices=["train", "inference"],
                       default="train")
        p.add_argument("--config_path", type=str, default="paths.yaml")
        p.add_argument("--height", type=int, default=192)
        p.add_argument("--width", type=int, default=640)
        p.add_argument("--no_PSP", action="store_true")
        p.add_argument("--device", type=str, choices=["cuda", "cpu"], default="cuda",
                       help="device to run on; cuda raises when absent")

        # The dump's loader and model; the training flags come with the
        # segmentation-training slice, which reads them
        p.add_argument("--batch_size", type=int, default=12)
        p.add_argument("--num_workers", type=int, default=4)
        p.add_argument("--split_root", type=str, default="splits")
        p.add_argument("--encoder_depth", type=int, choices=[18, 34, 50],
                       default=34)

        # Test
        p.add_argument("--load_path", type=str,
                       help="model checkpoint to load: an epoch_<n>.pth torch "
                            "file, a directory with checkpoint.npz, or the .npz")
        p.add_argument("--test_save_folder", type=str, default="ground_seg",
                       help="folder under the dataset's training_data path")
        p.add_argument("--test_data_type", choices=["kitti", "matterport"],
                       default="kitti")
        p.add_argument("--save_test_visualisations", action="store_true")

    def parse(self, argv=None):
        self.options = self.parser.parse_args(argv)
        return self.options
