"""Host-side loaders for GT generation, numpy (counterpart of
footprints_tpu/preprocessing/ground_truth_generation/data_loader.py; the
same arrays).

KITTI: frame-window loader (25 back / 50 forward, step 2, both stereo
sides) with a dict buffer keyed (sequence, frame, side); PSMNet disparity
rescaled by the width ratio then bilinear-resized; ground_seg
bilinear-resized then thresholded; ORB-SLAM2 pose npys.

Matterport: whole-scan loader; 16-bit depth PNGs x 0.00025; 4x4 pose txt;
intrinsics txt rescaled from 1280x1024.

OpenCV and Pillow are imported where a file is read, so the package
imports on a host without them.
"""

import os

import numpy as np

from ...core.ops import np_pixel_disp_to_depth


class BaseLoader:
    def __init__(self, raw_data_path, training_data_path, height, width,
                 footprint_threshold=0.75):
        self.raw_data_path = raw_data_path
        self.training_data_path = training_data_path
        self.height = height
        self.width = width
        self.footprint_threshold = footprint_threshold


class KITTILoader(BaseLoader):
    def __init__(self, raw_data_path, training_data_path, height, width,
                 num_frames_bwd=25, num_frames_fwd=50, footprint_threshold=0.75):
        super().__init__(raw_data_path, training_data_path, height, width,
                         footprint_threshold)
        self.num_frames_bwd = num_frames_bwd
        self.num_frames_fwd = num_frames_fwd
        self.buffer = {}
        self.K = np.array([[0.58, 0, 0.5, 0],
                           [0, 1.92, 0.5, 0],
                           [0, 0, 1, 0],
                           [0, 0, 0, 1]], np.float32)
        self.K[0] *= width
        self.K[1] *= height
        self.invK = np.linalg.pinv(self.K)
        self.stereo_baseline = 0.54

    @property
    def max_window_frames(self):
        """Frames in a full window (both sides)."""
        return 2 * len(range(-self.num_frames_bwd, self.num_frames_fwd, 2))

    def load_data(self, sequence, frame):
        """Window of neighbour frames around `frame` (both sides)."""
        disparities, ground_segs, poses, sides = [], [], [], []
        for frame_id in range(frame - self.num_frames_bwd,
                              frame + self.num_frames_fwd, 2):
            for side in ["image_02", "image_03"]:
                data = self.load_frame_data(sequence, frame_id, side)
                if data:
                    disparities.append(data["disparity"])
                    ground_segs.append(data["ground_seg"])
                    poses.append(data["pose"])
                    sides.append(side)
        # invalid (<=0) disparities -> depth 0, invalid everywhere downstream
        depths = np_pixel_disp_to_depth(
            np.stack(disparities), self.K[0, 0], self.stereo_baseline)
        n = len(sides)
        return {
            "depths": depths.astype(np.float32),
            "ground_segs": np.stack(ground_segs).astype(np.float32),
            "poses": np.stack(poses).astype(np.float32),
            "sides": sides,
            "intrinsics": np.tile(self.K[None], (n, 1, 1)),
            "inv_intrinsics": np.tile(self.invK[None], (n, 1, 1)),
        }

    def load_frame_data(self, sequence, frame, side, load_flow=False,
                        use_buffer=True, threshold_ground=True):
        import cv2

        if use_buffer:
            data = self.buffer.get((sequence, frame, side))
            if data:
                return data
        f = str(frame).zfill(10)
        try:
            disp = np.load(os.path.join(
                self.training_data_path, "stereo_matching_disps", sequence,
                side, f + ".npy"))
            disp = disp * (self.width / disp.shape[1])
            disp = cv2.resize(disp.astype(np.float64), (self.width, self.height))

            ground_seg = np.load(os.path.join(
                self.training_data_path, "ground_seg", sequence, side, "data",
                f + ".npy"))[0]
            ground_seg = cv2.resize(ground_seg.astype(np.float64),
                                    (self.width, self.height))
            if threshold_ground:
                ground_seg = (ground_seg > self.footprint_threshold).astype(float)

            pose = np.eye(4)
            pose[:3] = np.load(os.path.join(
                self.training_data_path, "poses", sequence, "orbslam_poses",
                f + ".npy")).reshape(3, 4)

            data = {"disparity": disp, "ground_seg": ground_seg, "pose": pose}
            if load_flow:
                flow = np.load(os.path.join(
                    self.training_data_path, "optical_flow", sequence, side,
                    "data", f + ".npy"))
                resized = np.zeros((2, self.height, self.width))
                resized[0] = cv2.resize(flow[0].astype(np.float64),
                                        (self.width, self.height)) * \
                    self.width / flow.shape[2]
                resized[1] = cv2.resize(flow[1].astype(np.float64),
                                        (self.width, self.height)) * \
                    self.height / flow.shape[1]
                data["flow"] = resized
            if use_buffer:
                self.buffer[(sequence, frame, side)] = data
            return data
        except FileNotFoundError:
            return None

    def purge_buffer(self):
        self.buffer = {}


class MatterportLoader(BaseLoader):
    FULL_WIDTH = 1280.0
    FULL_HEIGHT = 1024.0
    DEPTH_SCALING = 0.00025

    def __init__(self, raw_data_path, training_data_path, height, width,
                 footprint_threshold=0.75):
        super().__init__(raw_data_path, training_data_path, height, width,
                         footprint_threshold)
        self.current_scan = None
        self.scan_data = None
        self.pose_tracker = {}

    def load_data(self, scan, pos, height, direction):
        if self.current_scan != scan:
            self.pose_tracker = {}
            self.current_scan = scan
            self.load_scan_data()
        return dict(self.scan_data)

    def load_frame_data(self, scan, pos, height, direction):
        import cv2
        from PIL import Image

        scan_path = os.path.join(self.raw_data_path, scan, scan)
        ground_seg = (np.load(os.path.join(
            self.training_data_path, "ground_seg", scan, "data",
            f"{pos}_{height}_{direction}.npy"))[0]
            > self.footprint_threshold).astype(float)
        ground_seg = cv2.resize(ground_seg, (self.width, self.height),
                                interpolation=cv2.INTER_NEAREST)

        depth = Image.open(os.path.join(
            scan_path, "matterport_depth_images",
            f"{pos}_d{height}_{direction}.png")).resize(
            (self.width, self.height), Image.NEAREST)
        depth = np.array(depth).astype(float) * self.DEPTH_SCALING

        with open(os.path.join(scan_path, "matterport_camera_poses",
                               f"{pos}_pose_{height}_{direction}.txt")) as fh:
            pose = np.array(fh.read().split()).astype(float).reshape(4, 4)

        K = np.eye(4)
        with open(os.path.join(scan_path, "matterport_camera_intrinsics",
                               f"{pos}_intrinsics_{height}.txt")) as fh:
            vals = fh.read().split()
            K[0, 0] = float(vals[2])
            K[1, 1] = float(vals[3])
            K[0, 2] = float(vals[4])
            K[1, 2] = float(vals[5])
            K[0] *= self.width / self.FULL_WIDTH
            K[1] *= self.height / self.FULL_HEIGHT
        return ground_seg, depth, pose, K

    def load_scan_data(self):
        ground_segs, depths, poses, intrinsics, inv_intrinsics = [], [], [], [], []
        files = sorted(os.listdir(os.path.join(
            self.training_data_path, "ground_seg", self.current_scan, "data")))
        for file in files:
            if not file.endswith(".npy") or file.startswith("."):
                continue
            pos, height, direction = os.path.splitext(file)[0].split("_")
            ground_seg, depth, pose, K = self.load_frame_data(
                self.current_scan, pos, height, direction)
            ground_segs.append(ground_seg)
            depths.append(depth)
            poses.append(pose)
            intrinsics.append(K)
            inv_intrinsics.append(np.linalg.pinv(K))
            self.pose_tracker[(pos, height, direction)] = pose

        self.scan_data = {
            "depths": np.stack(depths).astype(np.float32),
            "ground_segs": np.stack(ground_segs).astype(np.float32),
            "poses": np.stack(poses).astype(np.float32),
            "intrinsics": np.stack(intrinsics).astype(np.float32),
            "inv_intrinsics": np.stack(inv_intrinsics).astype(np.float32),
        }
