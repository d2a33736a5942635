"""One-shot prediction CLI (counterpart of footprints_tpu/predict_simple.py).

Same flags and artifacts as the JAX CLI and the reference:
``<save_dir>/outputs/<name>.npy`` float32 [4,H,W] and
``<save_dir>/visualisations/<name>.jpg``, including the reference's quirk of
thresholding the hidden-ground channel at 0.5 on RAW LOGITS (pass
``--apply_sigmoid`` for probabilities).  Folder prediction runs in padded
batches of 4.  ``--artifact`` serves from an exported artifact
(export.py) in its traced batch and resolution instead of a checkpoint.
``--device {cuda,cpu}`` picks the device (default cuda; it raises when
CUDA is absent).  f32 runs with TF32 off.

On a CUDA device a checkpoint's forward is served from a CUDA graph,
captured at the first batch of each input shape and replayed for every
batch of that shape (``InferenceManager._forward``): one launch a batch in
place of the eager forward's hundreds.  On the CPU the forward runs eagerly.

Usage:
  python -m footprints_tpu_torch.predict_simple --image test_data/cyclist.jpg \
      --model_path /path/to/weights --save_dir predictions
"""

import argparse
import glob
import itertools
import os

import numpy as np
import torch

from .core.ops import np_sigmoid_to_depth
from .model_manager import ModelManager
from .telemetry import span
from .utils import MODEL_DIR, download_model_if_doesnt_exist, pil_loader

MODEL_HEIGHT_WIDTH = {
    "kitti": (192, 640),
    "matterport": (512, 640),
    "handheld": (256, 448),
}
IMAGE_EXTENSIONS = {".jpg", ".jpeg", ".png"}


class InferenceManager:
    def __init__(self, model_name, save_dir, save_visualisations=True,
                 model_load_folder=None, height=None, width=None,
                 apply_sigmoid=False, batch_size=4, artifact=None,
                 device="cuda"):
        self._serving = None
        self._calls = itertools.count()  # numbers the calls: their spans' unit
        self._graphs = {}  # input shape -> (static input, CUDA graph, static output)
        if artifact is not None:
            self._load_artifact(artifact, device, height, width,
                                apply_sigmoid or save_visualisations)
        else:
            self._load_model(model_name, model_load_folder, device, height, width)
            self.batch_size = batch_size
        self.apply_sigmoid = apply_sigmoid

        self.save_dir = save_dir
        os.makedirs(os.path.join(save_dir, "outputs"), exist_ok=True)
        self.save_visualisations = save_visualisations
        if save_visualisations:
            os.makedirs(os.path.join(save_dir, "visualisations"), exist_ok=True)

    def _load_model(self, model_name, model_load_folder, device, height, width):
        if model_load_folder is None:
            if model_name is None:
                raise ValueError(
                    "pass --model <kitti|matterport|handheld> (downloads the "
                    "pretrained checkpoint) or --model_path <weights dir>")
            download_model_if_doesnt_exist(model_name)
            model_load_folder = os.path.join(MODEL_DIR, model_name)
        self.model_manager = ModelManager(is_inference=True, device=device)
        self.model_manager.load_model(model_load_folder)
        self.device = self.model_manager.device

        if height is None or width is None:
            if model_name is None:
                height, width = MODEL_HEIGHT_WIDTH["kitti"]
                print(f"note: no --model given; assuming {height}x{width} "
                      "input (override with --height/--width)")
            else:
                height, width = MODEL_HEIGHT_WIDTH[model_name]
        self.height, self.width = height, width

    def _load_artifact(self, artifact, device, height, width, four_channel_options):
        """Serve from an exported artifact (export.py): no checkpoint or
        model code; resolution and batch come from the artifact.  A
        Segmentor artifact saves its [H,W] float16 ground map, and takes
        neither --apply_sigmoid nor visualisations."""
        from .export import load_serving

        self._serving = load_serving(artifact, device)
        if height is not None and (height, width) != (self._serving.height,
                                                      self._serving.width):
            raise ValueError(
                f"--height/--width {height}x{width} conflict with the "
                f"artifact's traced {self._serving.height}x{self._serving.width}")
        if self._serving.meta.get("model") == "Segmentor" and four_channel_options:
            raise ValueError("a Segmentor artifact's output is a ground "
                             "probability: pass --no_save_vis and no --apply_sigmoid")
        self.height, self.width = self._serving.height, self._serving.width
        self.batch_size = self._serving.batch
        self.device = self._serving.device

    def _forward(self, batch):
        """[B,H,W,3] numpy -> [B,4,H,W] numpy of the '1/1' scale, in the
        spans ``predict.forward`` (the upload and the forward, queued) and
        ``predict.fetch`` (the wait for the card and the copy back).

        On a CUDA device the forward is the replay of the graph of the
        batch's shape (``_capture``, at the shape's first batch): the batch
        is copied into the graph's static input, the replay is the span
        ``predict.graph.replay``, and the static output is copied back.  On
        the CPU the forward runs eagerly."""
        with torch.inference_mode():
            with span("predict.forward"):
                x = torch.from_numpy(batch)
                if self.device.type == "cuda":
                    static_x, graph, out = self._graphs.get(x.shape) or self._capture(x)
                    static_x.copy_(x)
                    with span("predict.graph.replay"):
                        graph.replay()
                else:
                    out = self._device_forward(x.to(self.device))
            with span("predict.fetch"):
                return out.cpu().numpy()

    def _device_forward(self, x):
        """The device side of a batch: the '1/1' forward, [B,4,H,W] f32."""
        out = self.model_manager.net(x, scales=("1/1",))["1/1"]
        return out.permute(0, 3, 1, 2).float()

    def _capture(self, x):
        """Capture ``_device_forward`` at ``x``'s shape as a CUDA graph, in
        the span ``predict.graph.capture``, and keep it in ``_graphs``:
        (its static input, holding ``x``; the graph; its static output).
        An eager forward on a side stream comes first, as the warm-up that
        PyTorch's graphs need (cuDNN's and the kernel's one-time set-up run
        there, outside the capture).  A failed capture raises."""
        with span("predict.graph.capture"), torch.cuda.device(self.device):
            static_x = x.to(self.device)
            main, side = torch.cuda.current_stream(), torch.cuda.Stream()
            side.wait_stream(main)
            with torch.cuda.stream(side):
                self._device_forward(static_x)
            main.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = self._device_forward(static_x)
        entry = self._graphs[x.shape] = static_x, graph, out
        return entry

    def _load_and_preprocess_image(self, image_path):
        from PIL import Image

        original = pil_loader(image_path)
        pre = original.resize((self.width, self.height), Image.LANCZOS)
        arr = np.asarray(pre, np.float32) / 255.0
        return original, arr

    def _predict_batch(self, arrs):
        """arrs: list of [H,W,3] -> [B,4,H,W] numpy (channels-first), in
        the span ``predict.batch`` with the call's number as its unit (and
        that of the spans inside)."""
        with span("predict.batch", unit=next(self._calls)):
            if self._serving is not None:
                preds = self._serving.call(np.stack(arrs))
            else:
                batch = np.zeros((self.batch_size, self.height, self.width, 3), np.float32)
                batch[: len(arrs)] = np.stack(arrs)
                preds = self._forward(batch)[: len(arrs)]
            if self.apply_sigmoid:
                preds[:, :2] = 1.0 / (1.0 + np.exp(-preds[:, :2]))
            return preds

    def predict_arrays(self, names, arrs, originals=None):
        """Predict preprocessed [H,W,3] arrays (at most one batch) and save
        each as ``outputs/<name>.npy``; with ``originals`` (PIL images) also
        the visualisations.  The CLI calls this after decoding."""
        preds = self._predict_batch(list(arrs))
        for i, (name, pred) in enumerate(zip(names, preds)):
            npy_save_path = os.path.join(self.save_dir, "outputs", name + ".npy")
            print(f"-> Saving predictions to {npy_save_path}")
            np.save(npy_save_path, pred)
            if self.save_visualisations and originals is not None:
                import cv2

                vis = self._visualise(pred, originals[i])
                vis_save_path = os.path.join(
                    self.save_dir, "visualisations", name + ".jpg")
                print(f"-> Saving visualisation to {vis_save_path}")
                cv2.imwrite(vis_save_path, (vis[:, :, ::-1] * 255).astype(np.uint8))
        return preds

    def predict_for_single_image(self, image_path):
        self.predict_for_paths([image_path])

    def predict_for_paths(self, paths):
        for start in range(0, len(paths), self.batch_size):
            chunk = paths[start:start + self.batch_size]
            originals, arrs = zip(*(self._load_and_preprocess_image(p) for p in chunk))
            for path in chunk:
                print(f"Predicting for {path}")
            names = [os.path.splitext(os.path.basename(p))[0] for p in chunk]
            self.predict_arrays(names, arrs, originals)

    def _visualise(self, pred, original):
        """Overlay plasma-mapped hidden depth on the hidden-ground region."""
        import cv2
        import matplotlib.pyplot as plt

        colormap = plt.get_cmap("plasma", 256)
        hidden_ground = cv2.resize(pred[1], original.size) > 0.5
        hidden_depth = cv2.resize(np_sigmoid_to_depth(pred[3]), original.size)
        img = np.array(original) / 255.0
        if hidden_ground.any():
            _max = hidden_depth[hidden_ground].max()
            _min = hidden_depth[hidden_ground].min()
            hidden_depth = (hidden_depth - _min) / max(_max - _min, 1e-7)
        depth_color = colormap(hidden_depth)[:, :, :3]
        mask = hidden_ground[:, :, None]
        return img * (1 - mask) + depth_color * mask

    def predict_for_folder(self, folder_path):
        paths = [p for p in sorted(glob.glob(os.path.join(folder_path, "*")))
                 if os.path.splitext(p)[1].lower() in IMAGE_EXTENSIONS]
        self.predict_for_paths(paths)

    def predict(self, image_path):
        if os.path.isfile(image_path):
            self.predict_for_single_image(image_path)
        elif os.path.isdir(image_path):
            self.predict_for_folder(image_path)
        else:
            raise FileNotFoundError(f"Can not find args.image: {image_path}")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Simple prediction from a footprints model (PyTorch/CUDA).")
    parser.add_argument("--image", type=str, required=True,
                        help="path to a test image or folder of images")
    parser.add_argument("--model", type=str,
                        choices=["kitti", "matterport", "handheld"],
                        help="name of a pretrained model to use")
    parser.add_argument("--model_path", type=str, default=None,
                        help="directory with model.pth or checkpoint.npz "
                             "(overrides --model download)")
    parser.add_argument("--artifact", type=str, default=None,
                        help="serve from an exported artifact (python -m "
                             "footprints_tpu_torch.export), loaded on --device; "
                             "resolution and batch come from the artifact")
    parser.add_argument("--height", type=int, default=None)
    parser.add_argument("--width", type=int, default=None)
    parser.add_argument("--no_save_vis", action="store_true",
                        help="if set, disables visualisation saving")
    parser.add_argument("--apply_sigmoid", action="store_true",
                        help="apply sigmoid to mask channels before saving "
                             "(reference parity default: raw logits)")
    parser.add_argument("--save_dir", type=str, default="predictions",
                        help="where to save npy and visualisations to")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="device to run on; cuda raises when CUDA is absent")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    manager = InferenceManager(
        model_name=args.model,
        save_dir=args.save_dir,
        save_visualisations=not args.no_save_vis,
        model_load_folder=args.model_path,
        height=args.height,
        width=args.width,
        apply_sigmoid=args.apply_sigmoid,
        artifact=args.artifact,
        device=args.device,
    )
    manager.predict(image_path=args.image)


if __name__ == "__main__":
    main()
