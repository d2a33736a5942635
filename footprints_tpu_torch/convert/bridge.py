"""Weight bridge between the JAX package's params/state pytrees and this
port's state_dict, both ways, and the JAX flat order of the parameters.

``state_dict_from_jax_params`` is the inverse of
footprints_tpu/convert/torch_checkpoint.py:footprint_params_from_state_dict,
and ``segmentor_state_dict_from_jax_params`` that of
``segmentor_params_from_state_dict``.
HWIO conv weights become OIHW; BN ``scale``/``bias``/``mean``/``var`` become
``weight``/``bias``/``running_mean``/``running_var``.  Keys the JAX pytree
does not hold get torch's defaults: the decoders' unused ConvBlock BNs
(weight 1, bias 0, mean 0, var 1) and every ``num_batches_tracked`` (0).
The result loads into ``FootprintNetwork`` (``Segmentor``) with
``load_state_dict(strict=True)``.

``jax_params_from_state_dict`` and ``segmentor_jax_params_from_state_dict``
are the port's own copies of ``footprint_params_from_state_dict`` and
``segmentor_params_from_state_dict`` (state_dict -> pytrees, numpy).

``ravel_params``/``unravel_params`` give the order of
``jax.flatten_util.ravel_pytree``, which optax.flatten's Adam moments use:
sorted dict keys, list items in order, ``None`` leaves skipped, each leaf
raveled in its JAX (HWIO) layout.  ``flat_from_named``/``named_from_flat``
map per-parameter tensors (Adam's ``exp_avg``/``exp_avg_sq``) to and from
that one flat vector.

Leaves may be numpy arrays, torch tensors or anything ``np.asarray``
accepts; this module imports no JAX.
"""

import numpy as np
import torch

from ..models.segmentor import PSP_POOL_SIZES
from ..nn.resnet import ARCHS


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


def segmentor_state_dict_from_jax_params(params, state, depth=34, use_psp=True):
    """JAX Segmentor (params, state) -> the port's state_dict (CPU f32), which
    is the reference Segmentor's layout."""
    sd = {}
    _put_encoder(sd, params["encoder"], state["encoder"], depth)
    _put_decoder(sd, "decoder", params["decoder"])
    if use_psp:  # reference PSP block i pools to PSP_POOL_SIZES[i - 1] cells
        for i, s in enumerate(PSP_POOL_SIZES, 1):
            _put_conv(sd, f"decoder.PSP.block{i}.reduce",
                      params["decoder"]["psp"][f"reduce{s}"])
    return sd


# --- state_dict -> JAX pytrees ----------------------------------------------

def _numpy(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _get_conv(sd, prefix, with_bias=True):
    w = np.ascontiguousarray(np.transpose(sd[prefix + ".weight"], (2, 3, 1, 0)))
    b = sd.get(prefix + ".bias") if with_bias else None
    return {"w": w, "b": None if b is None else b.copy()}


def _get_bn(sd, prefix):
    return ({"scale": sd[prefix + ".weight"].copy(), "bias": sd[prefix + ".bias"].copy()},
            {"mean": sd[prefix + ".running_mean"].copy(),
             "var": sd[prefix + ".running_var"].copy()})


def _get_encoder(sd, depth):
    kind, stage_blocks = ARCHS[depth]
    n_convs = 2 if kind == "basic" else 3
    p = {"stem_conv": _get_conv(sd, "encoder.layer0.0", with_bias=False)}
    s = {}
    p["stem_bn"], s["stem_bn"] = _get_bn(sd, "encoder.layer0.1")
    for si, n_blocks in enumerate(stage_blocks):
        name = f"layer{si + 1}"
        prefix = "encoder.layer1.1" if si == 0 else f"encoder.{name}"
        p[name], s[name] = [], []
        for bi in range(n_blocks):
            bp, bs = {}, {}
            for ci in range(1, n_convs + 1):
                bp[f"conv{ci}"] = _get_conv(sd, f"{prefix}.{bi}.conv{ci}", with_bias=False)
                bp[f"bn{ci}"], bs[f"bn{ci}"] = _get_bn(sd, f"{prefix}.{bi}.bn{ci}")
            if f"{prefix}.{bi}.downsample.0.weight" in sd:
                bp["down_conv"] = _get_conv(sd, f"{prefix}.{bi}.downsample.0",
                                            with_bias=False)
                bp["down_bn"], bs["down_bn"] = _get_bn(sd, f"{prefix}.{bi}.downsample.1")
            p[name].append(bp)
            s[name].append(bs)
    return p, s


def _get_conv_block(sd, prefix):
    return {"conv1": _get_conv(sd, prefix + ".conv1"),
            "conv2": _get_conv(sd, prefix + ".conv2")}


def _get_decoder(sd, name):
    p, s = {}, {}
    for i in range(1, 5):
        p[f"block{i}"] = {"pre": _get_conv_block(sd, f"{name}.block{i}.pre_concat_conv"),
                          "post": _get_conv_block(sd, f"{name}.block{i}.post_concat_conv")}
        s[f"block{i}"] = {"pre": {}, "post": {}}
    for oc in ("outconv1", "outconv2", "outconv3"):
        p[oc] = {"conv1": _get_conv(sd, f"{name}.{oc}.conv1")}
    p["outconv4_conv"], s["outconv4_conv"] = _get_conv_block(sd, f"{name}.outconv4.0"), {}
    p["outconv4_out"] = {"conv1": _get_conv(sd, f"{name}.outconv4.1.conv1")}
    return p, s


def jax_params_from_state_dict(sd, depth=34):
    """The port's (or the reference's) state_dict -> the JAX FootprintNetwork
    (params, state) pytrees of numpy arrays."""
    sd = {k: _numpy(v) for k, v in sd.items()}
    p, s = {}, {}
    p["encoder"], s["encoder"] = _get_encoder(sd, depth)
    p["mask_decoder"], s["mask_decoder"] = _get_decoder(sd, "mask_decoder")
    p["depth_decoder"], s["depth_decoder"] = _get_decoder(sd, "depth_decoder")
    return p, s


def segmentor_jax_params_from_state_dict(sd, depth=34, use_psp=True):
    """The port's (or the reference's) Segmentor state_dict -> the JAX
    Segmentor (params, state) pytrees of numpy arrays (the port's copy of
    ``segmentor_params_from_state_dict``)."""
    sd = {k: _numpy(v) for k, v in sd.items()}
    p, s = {}, {}
    p["encoder"], s["encoder"] = _get_encoder(sd, depth)
    p["decoder"], s["decoder"] = _get_decoder(sd, "decoder")
    if use_psp:
        p["decoder"]["psp"] = {
            f"reduce{ps}": _get_conv(sd, f"decoder.PSP.block{i}.reduce", with_bias=False)
            for i, ps in enumerate(PSP_POOL_SIZES, 1)}
    return p, s


# --- the JAX flat order -------------------------------------------------------

def _leaves(tree, out):
    if tree is None:
        return out
    if isinstance(tree, dict):
        for k in sorted(tree):
            _leaves(tree[k], out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _leaves(v, out)
    else:
        out.append(tree)
    return out


def ravel_params(params):
    """A params pytree -> one flat f32 vector in ravel_pytree order."""
    return np.concatenate([np.asarray(a, np.float32).ravel()
                           for a in _leaves(params, [])])


def unravel_params(flat, template):
    """Inverse of ``ravel_params``: ``flat`` cut into ``template``'s leaves."""
    flat = np.asarray(flat, np.float32)
    pos = 0

    def build(t):
        nonlocal pos
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        n = np.asarray(t).size
        leaf = flat[pos:pos + n].reshape(np.shape(t))
        pos += n
        return leaf

    out = build(template)
    if pos != flat.size:
        raise ValueError(f"flat vector has {flat.size} values; the pytree "
                         f"holds {pos}")
    return out


def flat_from_named(named, like_sd, depth=34):
    """{port parameter name: tensor} -> the flat JAX-order vector of the
    pytree's params.  Names ``named`` lacks count as zeros; ``like_sd`` (the
    net's state_dict) supplies every key's shape."""
    sd = {k: np.zeros(tuple(v.shape), np.float32) for k, v in like_sd.items()}
    sd.update({k: _numpy(v) for k, v in named.items()})
    return ravel_params(jax_params_from_state_dict(sd, depth)[0])


def named_from_flat(flat, like_sd, depth=34):
    """Inverse of ``flat_from_named``: {port parameter name: CPU f32 tensor}
    for every parameter of the JAX pytree."""
    params, state = jax_params_from_state_dict(like_sd, depth)
    full = state_dict_from_jax_params(unravel_params(flat, params), state, depth)
    tree_names = set(full) - _non_pytree_keys(full)
    return {k: full[k] for k in tree_names}


def _non_pytree_keys(sd):
    """Keys of a port state_dict that are not params of the JAX pytree: BN
    running stats and counters, and the decoders' unused BN modules."""
    out = set()
    for k in sd:
        if k.endswith(("running_mean", "running_var", "num_batches_tracked")):
            out.add(k)
        elif "_decoder." in k and ".bn" in k:
            out.add(k)
    return out
