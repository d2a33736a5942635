"""The port's GT-generation CLI (footprints_tpu_torch/preprocessing/
ground_truth_generation/generator.py, ``--device cpu``) against the JAX
CLI on the same small synthetic KITTI and Matterport trees, all five
(data_type, type) pairs: the same file names, dtypes and shapes; hidden
depths within 1e-5 relative where both are nonzero, with at most 1e-3 of
the pixels zero in one and nonzero in the other; masks differing at at most
1e-3 of the pixels; the --idx_start/--idx_end sharding; and the port's
dropping of the JAX CLI's padded and far frames bit-identical to keeping
them.

Without fed indices the port's RANSAC draws from a torch generator, so its
``depth_masks`` agree with the JAX CLI's in distribution, not pixel for
pixel: the mask comparison feeds the port JAX's triplet indices (the key
sequence of the JAX CLI, recomputed by ``_torch_port.jax_triplets``), and
the port's own draws are held to the names, dtypes and shapes.

Both packages' generator classes fix their working size as class
attributes; small subclasses set it here (the JAX side's e2e tests at the
full size are slow-marked)."""

import os
import shutil

import jax
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from footprints_tpu.preprocessing.ground_truth_generation import generator as jgen
from footprints_tpu_torch.preprocessing.ground_truth_generation import generator as gen
from footprints_tpu_torch.preprocessing.ground_truth_generation.geometry import (
    aggregate_hidden_depth,
)
from footprints_tpu_torch.preprocessing.ground_truth_generation.processing import (
    compute_depth_mask,
)

from ._torch_port import jax_triplets

KITTI_HW, KITTI_RAW_HW = (48, 160), (72, 240)
MP_HW, MP_RAW_HW = (48, 64), (128, 160)  # the depth PNGs at 1280x1024 / 8
SEQ = "seq0"
N_FRAMES = 12
CAM_HEIGHT = 1.5
KITTI_TARGETS = [f"{SEQ} {f} {s}" for f, s in ((3, "l"), (4, "r"), (5, "l"), (6, "l"))]
SPARSE_GROUND = (6, "image_02")  # a frame with no ground: the float64 zeros
# Matterport: two panoramas near each other and one 20 m away, 3 heights x 6
# directions each
PANORAMAS = {"aaaaaaaaaa": (0.0, 0.0), "bbbbbbbbbb": (1.5, 0.5),
             "ffffffffff": (20.0, 0.0)}
MP_TARGETS = ["scanA aaaaaaaaaa 1 0", "scanA aaaaaaaaaa 0 3",
              "scanA bbbbbbbbbb 1 1", "scanA ffffffffff 0 5"]


def _kitti_depth(h, w, cam_x, cam_z):
    """Ground 1.5 m below the camera and two boxes standing on it (world
    fixed), seen by a camera at (cam_x, 0, cam_z) looking along +z with the
    KITTI loader's intrinsics at h x w.  Returns (depth, 0 where no hit;
    ground hit mask)."""
    fx, fy, cx, cy = 0.58 * w, 1.92 * h, 0.5 * w, 0.5 * h
    u, v = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    dx, dy = (u - cx) / fx, (v - cy) / fy
    t_ground = np.where(dy > 1e-9, CAM_HEIGHT / np.maximum(dy, 1e-9), np.inf)
    t = t_ground.copy()
    for x0, x1, zb, hb in ((-3.0, -1.2, 9.0, 1.0), (1.5, 3.5, 12.0, 1.2)):
        tb = zb - cam_z
        if tb <= 0:
            continue
        x, y = cam_x + tb * dx, tb * dy
        hit = (x >= x0) & (x <= x1) & (y <= CAM_HEIGHT) & (y >= CAM_HEIGHT - hb)
        t = np.where(hit & (tb < t), tb, t)
    depth = np.where(t < 60.0, t, 0.0)
    return depth, (t == t_ground) & (depth > 0)


def _write_kitti(td):
    rng = np.random.RandomState(0)
    raw_h, raw_w = KITTI_RAW_HW
    for i in range(N_FRAMES):
        f = str(i).zfill(10)
        for side, cam_x in (("image_02", 0.0), ("image_03", 0.54)):
            depth, _ = _kitti_depth(raw_h, raw_w, cam_x, 0.5 * i)
            disp = np.where(depth > 0, 0.58 * raw_w * 0.54 / np.maximum(depth, 1e-9), 0)
            _, ground = _kitti_depth(*KITTI_HW, cam_x, 0.5 * i)
            if (i, side) == SPARSE_GROUND:
                ground[:] = False
            for sub, arr in (("stereo_matching_disps", disp.astype(np.float32)),
                             ("ground_seg", ground[None].astype(np.float16)),
                             ("optical_flow", rng.randn(2, raw_h, raw_w).astype(np.float32))):
                folder = os.path.join(td, sub, SEQ, side, "" if sub.startswith("st") else "data")
                os.makedirs(folder, exist_ok=True)
                np.save(os.path.join(folder, f + ".npy"), arr)
        pose = np.eye(4)[:3]
        pose[2, 3] = 0.5 * i
        os.makedirs(os.path.join(td, "poses", SEQ, "orbslam_poses"), exist_ok=True)
        np.save(os.path.join(td, "poses", SEQ, "orbslam_poses", f + ".npy"),
                pose.astype(np.float32))


def _camera_to_world(position, height, direction):
    """Level yaw steps of 60 degrees, pitch -30 / 0 / +30 by height index;
    camera axes x right, y down, z forward; world z up."""
    yaw, pitch = np.deg2rad(60.0 * direction), np.deg2rad(30.0 * (height - 1))
    forward = np.array([np.cos(yaw) * np.cos(pitch), np.sin(yaw) * np.cos(pitch),
                        np.sin(pitch)])
    right = np.array([np.sin(yaw), -np.cos(yaw), 0.0])
    down = np.cross(forward, right)
    pose = np.eye(4)
    pose[:3, :3] = np.stack([right, down, forward], 1)
    pose[:3, 3] = [position[0], position[1], CAM_HEIGHT]
    return pose


def _matterport_depth(pose, K, h, w):
    """Depth (z along the optical axis) of a room x in [-8, 30], y in [-6, 6],
    z in [0, 3] with a table-sized box, and the floor-hit mask."""
    u, v = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    rays = np.stack([(u - K[0, 2]) / K[0, 0], (v - K[1, 2]) / K[1, 1], np.ones_like(u)])
    d = np.einsum("ij,jhw->ihw", pose[:3, :3], rays)
    c = pose[:3, 3]
    t = np.full((h, w), np.inf)
    for axis, lo, hi in ((0, -8.0, 30.0), (1, -6.0, 6.0), (2, 0.0, 3.0)):
        for wall in (lo, hi):
            with np.errstate(divide="ignore", invalid="ignore"):
                tw = (wall - c[axis]) / d[axis]
            t = np.where((tw > 0) & (tw < t), tw, t)
    floor = t.copy()
    with np.errstate(divide="ignore", invalid="ignore"):
        t_floor = (0.0 - c[2]) / d[2]
    box_lo, box_hi = np.array([2.5, -1.0, 0.0]), np.array([3.5, 1.0, 0.8])
    with np.errstate(divide="ignore", invalid="ignore"):
        t0 = (box_lo[:, None, None] - c[:, None, None]) / d
        t1 = (box_hi[:, None, None] - c[:, None, None]) / d
    near = np.nanmax(np.minimum(t0, t1), axis=0)
    far = np.nanmin(np.maximum(t0, t1), axis=0)
    box = (near <= far) & (near > 0) & (near < t)
    t = np.where(box, near, t)
    ground = np.isclose(t, t_floor) & ~box & (floor == t)
    return t, ground


def _write_matterport(raw, td):
    scan_dir = os.path.join(raw, "scanA", "scanA")
    for sub in ("matterport_depth_images", "matterport_camera_poses",
                "matterport_camera_intrinsics"):
        os.makedirs(os.path.join(scan_dir, sub), exist_ok=True)
    os.makedirs(os.path.join(td, "ground_seg", "scanA", "data"))
    raw_h, raw_w = MP_RAW_HW
    K_full = np.array([[1075.0, 0, 640.0], [0, 1075.0, 512.0], [0, 0, 1]])
    K_raw = K_full * np.array([[raw_w / 1280.0], [raw_h / 1024.0], [1.0]])
    for pos, xy in PANORAMAS.items():
        for height in range(3):
            np.savetxt(os.path.join(scan_dir, "matterport_camera_intrinsics",
                                    f"{pos}_intrinsics_{height}.txt"),
                       [[1280, 1024, K_full[0, 0], K_full[1, 1], K_full[0, 2],
                         K_full[1, 2], 0, 0, 0, 0, 0]])
            for direction in range(6):
                pose = _camera_to_world(xy, height, direction)
                depth, _ = _matterport_depth(pose, K_raw, raw_h, raw_w)
                _, ground = _matterport_depth(
                    pose, K_full * np.array([[MP_HW[1] / 1280.0], [MP_HW[0] / 1024.0], [1]]),
                    *MP_HW)
                depth = np.where(depth < 16.0, depth, 0.0)  # past 16-bit range: a hole
                Image.fromarray((depth / 0.00025).astype(np.uint16)).save(
                    os.path.join(scan_dir, "matterport_depth_images",
                                 f"{pos}_d{height}_{direction}.png"))
                np.savetxt(os.path.join(scan_dir, "matterport_camera_poses",
                                        f"{pos}_pose_{height}_{direction}.txt"), pose)
                np.save(os.path.join(td, "ground_seg", "scanA", "data",
                                     f"{pos}_{height}_{direction}.npy"),
                        ground[None].astype(np.float16))


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("gt")
    _write_kitti(str(root / "kitti_td"))
    _write_matterport(str(root / "mp_raw"), str(root / "mp_td"))
    (root / "kitti.txt").write_text("\n".join(KITTI_TARGETS))
    (root / "matterport.txt").write_text("\n".join(MP_TARGETS))
    return root


def _small(cls, data_type):
    hw = KITTI_HW if data_type == "kitti" else MP_HW
    return type(cls.__name__, (cls,), {"height": hw[0], "width": hw[1]})


def _fed(cls):
    """The port's depth-mask generator fed the triplets that the JAX CLI
    draws: its PRNGKey(10), split once per frame that reaches RANSAC."""
    class Fed(cls):
        def __init__(self, opts):
            super().__init__(opts)
            self.key = jax.random.PRNGKey(10)

        def depth_mask(self, depth, ground_seg, K, invK):
            if (ground_seg > self.footprint_threshold).sum() < gen.MIN_GROUND_PIXELS:
                return super().depth_mask(depth, ground_seg, K, invK)
            self.key, sub = jax.random.split(self.key)
            depth, ground_seg = (np.asarray(a, np.float32) for a in (depth, ground_seg))
            fit = ((ground_seg > self.footprint_threshold) & (depth > 0)).reshape(-1)
            t = self.to_device
            return compute_depth_mask(
                t(depth), t(ground_seg), t(K), t(invK), height=self.height,
                width=self.width, footprint_threshold=self.footprint_threshold,
                idx=torch.from_numpy(jax_triplets(sub, fit)))
    return Fed


def _run(package, trees, tmp_path, data_type, kind, extra=(), fed=False):
    """Copy the tree, run one package's generator over it (the port's fed
    JAX's triplets if ``fed``), return the output folder's files {relative
    path: array}."""
    name = ("jax" if package is jgen else "port") + ("_fed" if fed else "")
    td = tmp_path / name
    shutil.copytree(trees / f"{'kitti' if data_type == 'kitti' else 'mp'}_td", td)
    config = tmp_path / f"{name}.yaml"
    config.write_text(yaml.safe_dump({data_type: {"dataset": str(trees / "mp_raw"),
                                                  "training_data": str(td)}}))
    argv = ["--type", kind, "--data_type", data_type, "--config_path", str(config),
            "--textfile", str(trees / f"{data_type}.txt"), *extra]
    if package is gen:
        argv += ["--device", "cpu"]
    cls = _small(package.GENERATORS[(data_type, kind)], data_type)
    if fed:
        cls = _fed(cls)
    cls(package.get_options(argv)).run()
    out = {}
    for folder in ("hidden_depths", "depth_masks", "moving_object_masks"):
        for d, _, files in os.walk(td / folder):
            for f in files:
                path = os.path.join(d, f)
                out[os.path.relpath(path, td)] = np.load(path)
    return out


PAIRS = [("kitti", "hidden_depths"), ("kitti", "depth_masks"),
         ("kitti", "moving_objects"), ("matterport", "hidden_depths"),
         ("matterport", "depth_masks")]


@pytest.mark.parametrize("data_type,kind", PAIRS)
def test_generator_matches_the_jax_cli(trees, tmp_path, data_type, kind):
    ref = _run(jgen, trees, tmp_path, data_type, kind)
    own = _run(gen, trees, tmp_path, data_type, kind)
    got = _run(gen, trees, tmp_path, data_type, kind, fed=True) if kind == "depth_masks" else own
    assert sorted(own) == sorted(got) == sorted(ref) and len(got) == 4
    hw = KITTI_HW if data_type == "kitti" else MP_HW
    zeros = 0
    for name in ref:
        g, r = got[name], ref[name]
        assert (g.dtype, g.shape) == (r.dtype, r.shape) == (r.dtype, hw), name
        assert (own[name].dtype, own[name].shape) == (r.dtype, r.shape), name
        if kind == "hidden_depths":
            assert g.dtype == np.float32 and (r > 0).sum() > 0.1 * r.size
            both = (g > 0) & (r > 0)
            np.testing.assert_allclose(g[both], r[both], rtol=1e-5)
            assert ((g > 0) != (r > 0)).mean() <= 1e-3
        elif r.dtype == np.float64:  # too little ground: the JAX CLI's zeros
            assert not g.any()
            zeros += 1
        else:
            assert g.dtype == np.bool_
            assert (g != r).mean() <= 1e-3
    if kind == "depth_masks":
        flagged = sum(r.sum() for r in ref.values() if r.dtype == np.bool_)
        assert flagged > 0 and zeros == (1 if data_type == "kitti" else 0)
    if kind == "moving_objects":
        assert sum(r.sum() for r in ref.values()) > 0


def test_idx_sharding(trees, tmp_path):
    """--idx_start/--idx_end slice the sorted split, as the JAX CLI does."""
    extra = ("--idx_start", "1", "--idx_end", "3")
    ref = _run(jgen, trees, tmp_path, "kitti", "moving_objects", extra)
    got = _run(gen, trees, tmp_path, "kitti", "moving_objects", extra)
    want = sorted(KITTI_TARGETS)[1:3]
    assert sorted(got) == sorted(ref)
    assert sorted(os.path.basename(n) for n in got) == sorted(
        f"{line.split()[1].zfill(10)}.npy" for line in want)


@pytest.mark.parametrize("data_type", ["kitti", "matterport"])
def test_dropping_padded_and_far_frames_is_exact(trees, tmp_path, data_type):
    """The JAX CLI pads each window with zero-depth frames, and zeroes
    Matterport's frames away from the target; the port leaves them out.
    Its aggregate over the JAX CLI's frames equals its own output."""
    got = _run(gen, trees, tmp_path, data_type, "hidden_depths")
    td = tmp_path / "port"
    config = tmp_path / "port.yaml"
    jax_side = _small(jgen.GENERATORS[(data_type, "hidden_depths")], data_type)(
        jgen.get_options(["--config_path", str(config),
                          "--textfile", str(trees / f"{data_type}.txt")]))
    port_side = _small(gen.GENERATORS[(data_type, "hidden_depths")], data_type)(
        gen.get_options(["--config_path", str(config), "--device", "cpu",
                         "--textfile", str(trees / f"{data_type}.txt")]))
    dropped = 0
    for i, line in enumerate(sorted(trees.joinpath(f"{data_type}.txt").read_text().split("\n"))):
        padded = jax_side.load_data(i, line)
        dropped += len(padded["depths"]) - len(port_side.load_data(i, line)["depths"])
        t = {k: torch.from_numpy(np.asarray(padded[k], np.float32))
             for k in ("depths", "poses", "intrinsics", "inv_intrinsics")}
        out = aggregate_hidden_depth(t["depths"], t["poses"], t["intrinsics"],
                                     t["inv_intrinsics"], height=port_side.height,
                                     width=port_side.width,
                                     robust=port_side.robust_aggregation).numpy()
        fields = line.split()
        if data_type == "kitti":
            cam = "image_02" if fields[2] == "l" else "image_03"
            name = os.path.join("hidden_depths", SEQ, cam, "data", fields[1].zfill(10) + ".npy")
        else:
            name = os.path.join("hidden_depths", "scanA", "data", "_".join(fields[1:]) + ".npy")
        np.testing.assert_array_equal(out, got[name])
        assert os.path.exists(td / name)
    assert dropped > 0


def test_cuda_is_the_default_device(trees, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    opts = gen.get_options(["--textfile", str(trees / "kitti.txt")])
    assert opts.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gen.GroundTruthGenerator(opts)


def test_unknown_pair_raises():
    with pytest.raises(NotImplementedError):
        gen.main(["--type", "moving_objects", "--data_type", "matterport",
                  "--device", "cpu"])
