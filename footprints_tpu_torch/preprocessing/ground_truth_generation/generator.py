"""Ground-truth generation CLI on the card (counterpart of
footprints_tpu/preprocessing/ground_truth_generation/generator.py).

  python -m footprints_tpu_torch.preprocessing.ground_truth_generation.generator \\
      --type hidden_depths --data_type kitti --textfile splits/kitti/train.txt

It writes the JAX CLI's files: ``<training_data>/<save_folder>/<sequence>/
<image_02|03>/data/<frame:010d>.npy`` (KITTI) and ``<training_data>/
<save_folder>/<scan>/data/<pos>_<height>_<direction>.npy`` (Matterport):
float32 [H,W] hidden depths, bool [H,W] masks, and float64 zeros for a
depth-mask frame with fewer than 100 ground pixels.

  * The per-frame work (backproject -> transform -> splat -> median, the
    depth mask, the moving-object mask) runs on ``--device`` (cuda unless
    ``--device cpu``); the loop is pipelined: a frame's result is fetched
    and saved on a writer thread while the main thread loads the next.
  * No frame padding: the frame count is dynamic, and a frame with zero
    depth adds no point, so Matterport's near-camera filter leaves the far
    frames out instead of zeroing them (the same output).
  * RANSAC's triplets come from one ``torch.Generator`` on the device,
    seeded 10: ``depth_masks`` agree with the JAX CLI's in distribution,
    not pixel for pixel (ransac.py).

Sharding across machines keeps the --idx_start/--idx_end contract over the
sorted split.
"""

import argparse
import os
import time

import numpy as np
import torch

from ...core.config import load_config, readlines
from ...core.ops import np_pixel_disp_to_depth
from ...data.loader import BackgroundWriter
from ...utils import select_device
from .data_loader import KITTILoader, MatterportLoader
from .geometry import aggregate_hidden_depth
from .processing import compute_depth_mask, compute_moving_object_mask

SEED = 10
MIN_GROUND_PIXELS = 100  # fewer -> the depth mask is all zeros


class GroundTruthGenerator:
    height = width = None  # set by subclass

    def __init__(self, opts):
        self.opts = opts
        self.device = select_device(opts.device)
        self.filenames = sorted(readlines(opts.textfile))
        end = None if opts.idx_end == -1 else opts.idx_end
        self.filenames = self.filenames[opts.idx_start:end]
        self.save_folder = opts.save_folder_name or "hidden_depths"
        self.footprint_threshold = opts.footprint_threshold
        self.robust_aggregation = True
        self.generator = torch.Generator(device=self.device).manual_seed(SEED)

    def parse_config(self, config_path, data_key):
        config = load_config(config_path)
        return config[data_key]["dataset"], config[data_key]["training_data"]

    def to_device(self, array):
        return torch.from_numpy(np.asarray(array, np.float32)).to(self.device)

    def load_data(self, idx, filename):
        raise NotImplementedError

    def process_data(self, data):
        # returns the device tensor: run() fetches it on the writer thread
        t = self.to_device
        return aggregate_hidden_depth(
            t(data["depths"]), t(data["poses"]), t(data["intrinsics"]),
            t(data["inv_intrinsics"]), height=self.height, width=self.width,
            robust=self.robust_aggregation)

    def depth_mask(self, depth, ground_seg, K, invK):
        """compute_depth_mask on the device, or the JAX CLI's float64 zeros
        when fewer than MIN_GROUND_PIXELS pixels are ground."""
        if (ground_seg > self.footprint_threshold).sum() < MIN_GROUND_PIXELS:
            return np.zeros((self.height, self.width))
        t = self.to_device
        return compute_depth_mask(
            t(depth), t(ground_seg), t(K), t(invK), height=self.height,
            width=self.width, footprint_threshold=self.footprint_threshold,
            generator=self.generator)

    def save_result(self, result, savepath, filename, save_viz=False):
        if torch.is_tensor(result):
            result = result.cpu().numpy()
        data_dir = os.path.join(savepath, "data")
        os.makedirs(data_dir, exist_ok=True)
        np.save(os.path.join(data_dir, f"{str(filename).zfill(10)}.npy"), result)
        if save_viz:
            import matplotlib.pyplot as plt

            viz_dir = os.path.join(savepath, "visualisations")
            os.makedirs(viz_dir, exist_ok=True)
            plt.imsave(os.path.join(viz_dir, f"{str(filename).zfill(10)}.jpg"),
                       np.asarray(result, np.float32))

    def run(self):
        """Per-frame loop, pipelined: frame i's device work is enqueued and
        its fetch + np.save run on a writer thread while the main thread
        does frame i+1's host-side loads."""
        t0 = time.time()
        print(f"running ground truth generation on {len(self.filenames)} files...")
        # max_pending bounds the device results awaiting their fetch
        with BackgroundWriter(max_pending=8) as writer:
            for i, filename in enumerate(self.filenames):
                if i % 25 == 0 and i:
                    print(f"computing image {i} of {len(self.filenames)}; "
                          f"avg {(time.time() - t0) / i:.2f}s/image")
                data = self.load_data(i, filename)
                result = self.process_data(data)
                writer.submit(self.save_result_for, result, filename)


class KITTIGroundTruthGenerator(GroundTruthGenerator):
    height, width = 192, 640

    def __init__(self, opts):
        super().__init__(opts)
        self.raw_datapath, self.training_datapath = self.parse_config(
            opts.config_path, "kitti")
        self.loader = KITTILoader(self.raw_datapath, self.training_datapath,
                                  self.height, self.width,
                                  footprint_threshold=self.footprint_threshold)
        self.sequence_in_buffer = None

    def load_data(self, idx, filename):
        sequence, frame, side = filename.split()
        if sequence != self.sequence_in_buffer or len(self.loader.buffer) > 1000:
            self.loader.purge_buffer()
            self.sequence_in_buffer = sequence

        cam = "image_02" if side == "l" else "image_03"
        baseline = self.loader.stereo_baseline * (1.0 if side == "l" else -1.0)

        data = self.loader.load_data(sequence, int(frame))
        data["depths"] = data["depths"] * data["ground_segs"]

        base_pose = self.loader.load_frame_data(sequence, int(frame), cam)["pose"]
        inv_base = np.linalg.pinv(base_pose).astype(np.float32)
        data["poses"] = np.einsum("ij,njk->nik", inv_base, data["poses"])
        for i, s in enumerate(data["sides"]):
            if s != cam:
                data["poses"][i, 0, 3] += baseline
        return data

    def save_result_for(self, result, filename):
        sequence, frame, side = filename.split()
        cam = "image_02" if side == "l" else "image_03"
        savepath = os.path.join(self.training_datapath, self.save_folder,
                                sequence, cam)
        self.save_result(result, savepath, frame,
                         save_viz=self.opts.save_visualisations)


class KITTIMovingObjectDetector(KITTIGroundTruthGenerator):
    def __init__(self, opts):
        super().__init__(opts)
        self.save_folder = opts.save_folder_name or "moving_object_masks"

    def load_data(self, idx, filename):
        sequence, frame, side = filename.split()
        if sequence != self.sequence_in_buffer or len(self.loader.buffer) > 1000:
            self.loader.purge_buffer()
            self.sequence_in_buffer = sequence
        cam = "image_02" if side == "l" else "image_03"
        base = self.loader.load_frame_data(sequence, int(frame), cam,
                                           load_flow=True)
        lookup = self.loader.load_frame_data(sequence, int(frame) - 1, cam,
                                             load_flow=True)
        if lookup is None:
            lookup = self.loader.load_frame_data(sequence, int(frame) + 1, cam,
                                                 load_flow=True)
        return {"base_data": base, "lookup_data": lookup}

    def process_data(self, data):
        base, lookup = data["base_data"], data["lookup_data"]
        T = (np.linalg.pinv(lookup["pose"]) @ base["pose"]).astype(np.float32)
        # invalid disparity -> depth 0 -> never flagged moving
        depth = np_pixel_disp_to_depth(
            base["disparity"], self.loader.K[0, 0], self.loader.stereo_baseline)
        t = self.to_device
        return compute_moving_object_mask(
            t(depth), t(T), t(self.loader.K), t(self.loader.invK), t(base["flow"]),
            height=self.height, width=self.width)


class KITTIDepthMaskingGenerator(KITTIGroundTruthGenerator):
    def __init__(self, opts):
        super().__init__(opts)
        self.save_folder = opts.save_folder_name or "depth_masks"

    def load_data(self, idx, filename):
        sequence, frame, side = filename.split()
        cam = "image_02" if side == "l" else "image_03"
        return self.loader.load_frame_data(sequence, int(frame), cam,
                                           use_buffer=False,
                                           threshold_ground=False)

    def process_data(self, data):
        depth = np_pixel_disp_to_depth(
            data["disparity"], self.loader.K[0, 0], self.loader.stereo_baseline)
        return self.depth_mask(depth, data["ground_seg"], self.loader.K,
                               self.loader.invK)


class MatterportGroundTruthGenerator(GroundTruthGenerator):
    height, width = 480, 640

    def __init__(self, opts):
        super().__init__(opts)
        self.raw_datapath, self.training_datapath = self.parse_config(
            opts.config_path, "matterport")
        self.loader = MatterportLoader(self.raw_datapath, self.training_datapath,
                                       self.height, self.width,
                                       footprint_threshold=self.footprint_threshold)
        self.robust_aggregation = False

    def load_data(self, idx, filename):
        scan, pos, height, direction = filename.split()
        data = self.loader.load_data(scan, pos, height, direction)
        base_pose = self.loader.pose_tracker[(pos, height, direction)]
        inv_base = np.linalg.pinv(base_pose).astype(np.float32)
        # near-camera filter: the JAX CLI zeroes the other frames' depths;
        # they add no point, so they are left out
        poses = data["poses"]
        close = np.flatnonzero((np.abs(base_pose[0, 3] - poses[:, 0, 3]) < 10)
                               & (np.abs(base_pose[1, 3] - poses[:, 1, 3]) < 10)
                               & (np.abs(base_pose[2, 3] - poses[:, 2, 3]) < 1))
        return {
            "depths": data["depths"][close] * data["ground_segs"][close],
            "poses": np.einsum("ij,njk->nik", inv_base, poses)[close],
            "intrinsics": data["intrinsics"][close],
            "inv_intrinsics": data["inv_intrinsics"][close],
        }

    def save_result_for(self, result, filename):
        scan, pos, height, direction = filename.split()
        savepath = os.path.join(self.training_datapath, self.save_folder, scan)
        self.save_result(result, savepath, f"{pos}_{height}_{direction}",
                         save_viz=self.opts.save_visualisations)


class MatterportDepthMaskingGenerator(MatterportGroundTruthGenerator):
    def __init__(self, opts):
        super().__init__(opts)
        self.save_folder = opts.save_folder_name or "depth_masks"

    def load_data(self, idx, filename):
        scan, pos, height, direction = filename.split()
        ground_seg, depth, _, K = self.loader.load_frame_data(
            scan, pos, height, direction)
        return {"depth": depth.astype(np.float32),
                "ground_seg": ground_seg.astype(np.float32),
                "K": K.astype(np.float32),
                "invK": np.linalg.pinv(K).astype(np.float32)}

    def process_data(self, data):
        return self.depth_mask(data["depth"], data["ground_seg"], data["K"],
                               data["invK"])


def get_options(argv=None):
    parser = argparse.ArgumentParser(
        description="process frames to generate footprint training data")
    parser.add_argument("--config_path", type=str, default="paths.yaml")
    parser.add_argument("--type", type=str,
                        choices=["hidden_depths", "moving_objects", "depth_masks"])
    parser.add_argument("--data_type", type=str,
                        choices=["kitti", "matterport"])
    parser.add_argument("--save_folder_name", type=str)
    parser.add_argument("--save_visualisations", action="store_true")
    parser.add_argument("--textfile", type=str,
                        help="textfile containing frames to be computed")
    parser.add_argument("--idx_start", type=int, default=0)
    parser.add_argument("--idx_end", type=int, default=-1)
    parser.add_argument("--footprint_threshold", type=float, default=0.75)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the default; raises without a card) or cpu")
    return parser.parse_args(argv)


GENERATORS = {
    ("kitti", "hidden_depths"): KITTIGroundTruthGenerator,
    ("kitti", "moving_objects"): KITTIMovingObjectDetector,
    ("kitti", "depth_masks"): KITTIDepthMaskingGenerator,
    ("matterport", "hidden_depths"): MatterportGroundTruthGenerator,
    ("matterport", "depth_masks"): MatterportDepthMaskingGenerator,
}


def main(argv=None):
    """Run one generator over its split; returns it."""
    opts = get_options(argv)
    try:
        cls = GENERATORS[(opts.data_type, opts.type)]
    except KeyError:
        raise NotImplementedError(
            f"no generator for data_type={opts.data_type}, type={opts.type}")
    generator = cls(opts)
    generator.run()
    return generator


if __name__ == "__main__":
    main()
