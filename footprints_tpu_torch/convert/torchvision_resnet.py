"""ImageNet-pretrained encoder initialisation from a local ``.pth``
(counterpart of footprints_tpu/convert/torchvision_resnet.py).

The reference builds both networks from torchvision's pretrained ResNet, so
every training run it made starts from those weights.  ``--pretrained_encoder
<path>`` reproduces that start: the file is a torchvision ResNet state_dict
(``conv1.weight``, ``bn1.*``, ``layer1.0.conv1.weight``, ..., ``fc.*``) or a
state_dict already in the reference's wrapped-encoder layout
(``encoder.layer0.0.weight``, e.g. a published model.pth).  torchvision keys
are renamed into the wrapped layout, which is the port's own parameter
naming, and read by the weight bridge's encoder mapper (bridge.py).

Every tensor of the file must be read by the requested depth; a leftover,
a missing key or a shape that differs from the model's raises ``ValueError``
before the first step.  The JAX package's ``'download'`` value is not
ported: the port reads no network, and the value raises.
"""

import os

import numpy as np
import torch

from .bridge import _get_encoder, _numpy, _put_encoder


def load_state_dict_file(path):
    """A ``.pth`` state_dict -> {key: CPU tensor}, read with
    ``torch.load(weights_only=True)`` (no pickled code runs)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(sd, dict):
        raise ValueError(f"{path}: expected a state_dict, got {type(sd)}")
    return sd


def _rename_torchvision_keys(sd):
    """torchvision ResNet state_dict -> the reference's wrapped-encoder
    naming (layer0 = Sequential(conv1, bn1, relu), layer1 =
    Sequential(maxpool, layer1), layer2..4 as they are); ``fc.*`` dropped."""
    out = {}
    for k, v in sd.items():
        if k.startswith("fc."):
            continue  # the classifier head: the encoder has none
        if k.startswith("conv1."):
            out["encoder.layer0.0." + k[len("conv1."):]] = v
        elif k.startswith("bn1."):
            out["encoder.layer0.1." + k[len("bn1."):]] = v
        elif k.startswith("layer1."):
            out["encoder.layer1.1." + k[len("layer1."):]] = v
        elif k.startswith(("layer2.", "layer3.", "layer4.")):
            out["encoder." + k] = v
        else:
            raise ValueError(f"unrecognized torchvision ResNet key: {k}")
    return out


class _KeyTracker(dict):
    """A dict that records the keys read, so a deeper file read at a
    shallower depth (every key the shallower net reads exists, with its
    shape) cannot pass as a plausible shallower encoder."""

    def __init__(self, base):
        super().__init__(base)
        self.used = set()

    def __getitem__(self, k):
        self.used.add(k)
        return super().__getitem__(k)


def _encoder_from(sd, depth, what):
    """(params, state) of the encoder in ``sd`` (wrapped layout), every
    tensor of it read."""
    sd = _KeyTracker({k: _numpy(v) for k, v in sd.items()})
    try:
        out = _get_encoder(sd, depth)
    except KeyError as e:
        raise ValueError(f"{what}: no {e} for a resnet{depth} encoder "
                         f"(wrong --encoder_depth for this file?)") from None
    leftover = {k for k in sd if k not in sd.used
                and not k.endswith("num_batches_tracked")}
    if leftover:
        raise ValueError(
            f"{what}: {len(leftover)} weight tensors were not consumed by the "
            f"requested encoder depth (wrong --encoder_depth for this file?): "
            f"e.g. {sorted(leftover)[:4]}")
    return out


def encoder_from_torchvision_state_dict(sd, depth=34):
    """torchvision ResNet state_dict -> encoder (params, state) pytrees of
    numpy arrays, in the JAX package's layout."""
    return _encoder_from(_rename_torchvision_keys(sd), depth, "torchvision state_dict")


def load_pretrained_encoder(path, depth=34):
    """Encoder (params, state) from a ``.pth``: a raw torchvision ResNet
    state_dict, or one in the reference's wrapped layout (its ``encoder.*``
    keys; the rest, e.g. a model's decoders, is ignored)."""
    sd = load_state_dict_file(path)
    if any(k.startswith("encoder.layer0.0.") for k in sd):
        return _encoder_from({k: v for k, v in sd.items() if k.startswith("encoder.")},
                             depth, "wrapped-encoder state_dict")
    return encoder_from_torchvision_state_dict(sd, depth)


def _leaf_shapes(tree, path=""):
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _leaf_shapes(tree[k], f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [s for i, v in enumerate(tree) for s in _leaf_shapes(v, f"{path}/{i}")]
    return [] if tree is None else [(path, tuple(np.shape(tree)))]


def resolve_pretrained_encoder(spec, depth=34, expected=None):
    """A ``--pretrained_encoder`` value (a local ``.pth`` path) ->
    (params, state).  ``expected``, the model's own encoder (params, state),
    must match the loaded trees leaf for leaf in path and shape, so a wrong
    depth or architecture fails here."""
    if spec == "download":
        raise NotImplementedError(
            "--pretrained_encoder download is not ported: the port fetches "
            "nothing from the network; pass the path of a local .pth "
            "(torchvision's resnet state_dict or a reference checkpoint)")
    if not os.path.exists(spec):
        raise FileNotFoundError(f"pretrained encoder weights not found: {spec}")
    out = load_pretrained_encoder(spec, depth=depth)
    if expected is not None:
        for got, want in zip(out, expected):
            gs, ws = _leaf_shapes(got), _leaf_shapes(want)
            if gs != ws:
                raise ValueError(f"pretrained encoder layout mismatch (is it a "
                                 f"resnet{depth}?): {sorted(set(ws) ^ set(gs))[:4]}")
    return out


def init_encoder_from(net, spec):
    """Replace ``net.encoder``'s weights and BN statistics (a
    FootprintNetwork or a Segmentor) by those of ``spec``; the decoders
    keep theirs."""
    sd = {k: _numpy(v) for k, v in net.state_dict().items()}
    params, state = resolve_pretrained_encoder(spec, net.depth,
                                               expected=_get_encoder(sd, net.depth))
    enc = {}
    _put_encoder(enc, params, state, net.depth)
    unexpected = net.load_state_dict(enc, strict=False).unexpected_keys
    if unexpected:
        raise ValueError(f"{type(net).__name__} has no encoder weights {unexpected[:4]}")
