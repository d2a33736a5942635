"""Weight bridge: the JAX package's params/state pytrees -> this port's
state_dict.

The inverse of footprints_tpu/convert/torch_checkpoint.py:
footprint_params_from_state_dict.  HWIO conv weights become OIHW; BN
``scale``/``bias``/``mean``/``var`` become ``weight``/``bias``/
``running_mean``/``running_var``.  Keys the JAX pytree does not hold get
torch's defaults: the decoders' unused ConvBlock BNs (weight 1, bias 0,
mean 0, var 1) and every ``num_batches_tracked`` (0).  The result loads into
``FootprintNetwork`` with ``load_state_dict(strict=True)``.

Leaves may be numpy arrays or anything ``np.asarray`` accepts; this module
imports no JAX.
"""

import numpy as np
import torch

from .nn.resnet import ARCHS


def _tensor(a):
    return torch.from_numpy(np.array(a, np.float32, order="C"))


def _put_conv(sd, prefix, conv):
    sd[prefix + ".weight"] = _tensor(np.transpose(np.asarray(conv["w"]), (3, 2, 0, 1)))
    if conv.get("b") is not None:
        sd[prefix + ".bias"] = _tensor(conv["b"])


def _put_bn(sd, prefix, params, state):
    sd[prefix + ".weight"] = _tensor(params["scale"])
    sd[prefix + ".bias"] = _tensor(params["bias"])
    sd[prefix + ".running_mean"] = _tensor(state["mean"])
    sd[prefix + ".running_var"] = _tensor(state["var"])
    sd[prefix + ".num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _put_identity_bn(sd, prefix, c):
    ones, zeros = np.ones(c, np.float32), np.zeros(c, np.float32)
    _put_bn(sd, prefix, {"scale": ones, "bias": zeros},
            {"mean": zeros, "var": ones})


def _put_encoder(sd, p, s, depth):
    kind, stage_blocks = ARCHS[depth]
    n_convs = 2 if kind == "basic" else 3
    _put_conv(sd, "encoder.layer0.0", p["stem_conv"])
    _put_bn(sd, "encoder.layer0.1", p["stem_bn"], s["stem_bn"])
    for si, n_blocks in enumerate(stage_blocks):
        name = f"layer{si + 1}"
        # layer1 is wrapped in a Sequential with the maxpool at index 0
        prefix = "encoder.layer1.1" if si == 0 else f"encoder.{name}"
        for bi in range(n_blocks):
            bp, bs = p[name][bi], s[name][bi]
            for ci in range(1, n_convs + 1):
                _put_conv(sd, f"{prefix}.{bi}.conv{ci}", bp[f"conv{ci}"])
                _put_bn(sd, f"{prefix}.{bi}.bn{ci}", bp[f"bn{ci}"], bs[f"bn{ci}"])
            if "down_conv" in bp:
                _put_conv(sd, f"{prefix}.{bi}.downsample.0", bp["down_conv"])
                _put_bn(sd, f"{prefix}.{bi}.downsample.1", bp["down_bn"],
                        bs["down_bn"])


def _put_conv_block(sd, prefix, p):
    for i in (1, 2):
        _put_conv(sd, f"{prefix}.conv{i}", p[f"conv{i}"])
        _put_identity_bn(sd, f"{prefix}.bn{i}", np.asarray(p[f"conv{i}"]["w"]).shape[-1])


def _put_decoder(sd, name, p):
    for i in range(1, 5):
        _put_conv_block(sd, f"{name}.block{i}.pre_concat_conv", p[f"block{i}"]["pre"])
        _put_conv_block(sd, f"{name}.block{i}.post_concat_conv", p[f"block{i}"]["post"])
    for oc in ("outconv1", "outconv2", "outconv3"):
        _put_conv(sd, f"{name}.{oc}.conv1", p[oc]["conv1"])
    _put_conv_block(sd, f"{name}.outconv4.0", p["outconv4_conv"])
    _put_conv(sd, f"{name}.outconv4.1.conv1", p["outconv4_out"]["conv1"])


def state_dict_from_jax_params(params, state, depth=34):
    """JAX FootprintNetwork (params, state) -> the port's state_dict (CPU f32)."""
    sd = {}
    _put_encoder(sd, params["encoder"], state["encoder"], depth)
    _put_decoder(sd, "mask_decoder", params["mask_decoder"])
    _put_decoder(sd, "depth_decoder", params["depth_decoder"])
    return sd
