"""Segmentation-pipeline CLI options (counterpart of
footprints_tpu/preprocessing/segmentation/options.py): the JAX package's
flags with its defaults, plus ``--device``."""

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

        # Training
        p.add_argument("--training_datasets", type=str, nargs="+",
                       choices=["ADE20K", "cityscapes", "matterport"],
                       default=["ADE20K", "cityscapes"])
        p.add_argument("--epochs", type=int, default=20)
        p.add_argument("--log_freq", type=int, default=250)
        p.add_argument("--batch_size", type=int, default=12)
        p.add_argument("--val_batches", type=int, default=10)
        p.add_argument("--lr", type=float, default=1e-4)
        p.add_argument("--compute_dtype", type=str, default="float32",
                       choices=["float32", "bfloat16"],
                       help="train-step compute dtype: bfloat16 runs the forward "
                            "on bf16 copies of the f32 master params (f32 loss, "
                            "BN statistics in f32); validation stays f32")
        p.add_argument("--host_batch_compact", type=str, default="exact",
                       choices=["none", "exact", "f16"],
                       help="host->device batch encoding (data/compact.py); "
                            "'exact' is bitwise-lossless uint8 transport")
        p.add_argument("--num_workers", type=int, default=4)
        p.add_argument("--model_name", type=str, default="model")
        p.add_argument("--log_path", type=str, default="./logs")
        p.add_argument("--split_root", type=str, default="splits")
        p.add_argument("--encoder_depth", type=int, choices=[18, 34, 50],
                       default=34)
        p.add_argument("--pretrained_encoder", type=str, default=None,
                       help="initialise the encoder from a local .pth: "
                            "torchvision's ResNet layout or the reference's "
                            "wrapped encoder ('download' is not ported)")
        p.add_argument("--log_images", action="store_true",
                       help="log [image | gt | prediction] panels to "
                            "tensorboard at log cadence (needs matplotlib)")

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
