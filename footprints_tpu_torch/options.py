"""CLI options of ``main`` (counterpart of footprints_tpu/options.py): the
JAX package's flags, plus ``--device``."""

import argparse


class Options:
    def __init__(self):
        self.options = None
        self.parser = argparse.ArgumentParser()
        p = self.parser

        # Universal
        p.add_argument("--mode", type=str, choices=["train", "inference"],
                       default="train", help="training or inference mode")
        p.add_argument("--height", type=int, default=192, help="input height")
        p.add_argument("--width", type=int, default=640, help="input width")
        p.add_argument("--depth_range", nargs="+", type=float, default=[0.1, 100],
                       help="range of depth values")
        p.add_argument("--device", type=str, choices=["cuda", "cpu"], default="cuda",
                       help="device to run on; cuda raises when absent")

        # Training
        p.add_argument("--training_dataset", type=str,
                       choices=["kitti", "matterport"], default="kitti")
        p.add_argument("--epochs", type=int, default=10)
        p.add_argument("--log_freq", type=int, default=250,
                       help="frequency of tensorboard logs + validation")
        p.add_argument("--val_batches", type=int, default=10,
                       help="validation batches to average over")
        p.add_argument("--batch_size", type=int, default=12)
        p.add_argument("--lr", type=float, default=1e-4)
        # accepted but unwired, as in the reference (its options.py:66 flag
        # is read by nothing); the prior always applies with weight
        # --footprint_prior
        p.add_argument("--use_footprint_prior", action="store_true",
                       help="accepted for CLI parity; unwired in the reference too")
        p.add_argument("--footprint_prior", type=float, default=0.25,
                       help="weight for negative hidden footprint prior")
        p.add_argument("--no_depth_mask", action="store_true",
                       help="disable definitely-not-ground pixels")
        p.add_argument("--moving_objects_method", type=str,
                       choices=["none", "ours"], default="ours")
        p.add_argument("--project_down_baseline", action="store_true")
        p.add_argument("--num_workers", type=int, default=8,
                       help="prefetch worker threads")
        p.add_argument("--config_path", type=str, default="paths.yaml")
        p.add_argument("--model_name", type=str, default="model")
        p.add_argument("--log_path", type=str, default="./logs")
        p.add_argument("--log_images", action="store_true",
                       help="also log image panels to tensorboard")
        p.add_argument("--encoder_depth", type=int, choices=[18, 34, 50],
                       default=34, help="ResNet encoder depth (checkpoint "
                                        "contract: 34)")
        p.add_argument("--pretrained_encoder", type=str, default=None,
                       help="initialise the encoder from a local .pth: "
                            "torchvision's ResNet layout or the reference's "
                            "wrapped encoder ('download' is not ported)")
        p.add_argument("--split_root", type=str, default="splits",
                       help="root directory of split txt files")
        p.add_argument("--compute_dtype", type=str, default="float32",
                       choices=["float32", "bfloat16"],
                       help="forward/backward compute dtype; bfloat16 = "
                            "mixed precision (f32 master params, f32 loss)")
        p.add_argument("--host_batch_compact", type=str, default="exact",
                       choices=["none", "exact", "f16"],
                       help="host->device batch encoding (data/compact.py): "
                            "'exact' ships uint8 image/masks and decodes on "
                            "the device, bitwise lossless; 'f16' also ships "
                            "depth maps as float16 (~1e-3 rel loss); 'none' "
                            "= raw f32")
        p.add_argument("--s2d_head", type=str, default="auto",
                       choices=["auto", "on", "off"],
                       help="score the '1/1' scale in s2d layout against "
                            "targets packed on the put path; 'auto' turns it "
                            "on with bfloat16 compute")
        p.add_argument("--p4_head", type=str, default="auto",
                       choices=["auto", "on", "off"],
                       help="score the '1/2' scale in period-4 layout "
                            "against targets packed on the put path; 'auto' "
                            "turns it on with bfloat16 compute")
        p.add_argument("--debug_nans", action="store_true",
                       help="torch.autograd.set_detect_anomaly (debugging only)")
        p.add_argument("--profile_dir", type=str, default=None,
                       help="write a torch.profiler trace of steps 10-15 here")

        # Inference
        p.add_argument("--inference_data_type", choices=["kitti", "matterport"],
                       default="kitti")
        p.add_argument("--load_path", type=str, help="model path to load from")
        p.add_argument("--inference_save_path", default=None,
                       help="defaults to <load_path>/<data_type>_predictions/")
        p.add_argument("--save_test_visualisations", action="store_true")

    def parse(self, argv=None):
        self.options = self.parser.parse_args(argv)
        return self.options
