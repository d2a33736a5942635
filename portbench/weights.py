"""Seeded weights for both sides of a cell, made on the device in a few
large calls from one ``torch.Generator``.

The plain reference model (``reference/models.py``) names every leaf as the
port does, so one state dict made here loads into both.  Convs of the
encoder are drawn as torchvision draws them (normal, std sqrt(2 /
fan_out)), the decoders' convs with std 1.15 / sqrt(fan_in): at that gain
the served maps at 192x640 spread between about 0.03 and 0.99 (PyTorch's
default init, gain 0.58, collapses them to a constant; 1.5 saturates
them), so a comparison of the maps sees the arithmetic.  BN leaves are
drawn around identity, running variances kept positive, so eval-mode BN
is not an identity and every leaf is exercised.
"""

import math

import torch
import torch.nn as nn

DECODER_GAIN = 1.15


def _leaves(model):
    """[(state_dict key, kind, tensor)] in state_dict order, kind one of
    conv_w_enc, conv_w_dec, conv_b, bn_w, bn_b, bn_mean, bn_var, count."""
    kinds = {}
    for mod_name, mod in model.named_modules():
        prefix = f"{mod_name}." if mod_name else ""
        if isinstance(mod, nn.Conv2d):
            enc = mod_name.startswith("encoder")
            kinds[prefix + "weight"] = "conv_w_enc" if enc else "conv_w_dec"
            kinds[prefix + "bias"] = "conv_b"
        elif isinstance(mod, nn.BatchNorm2d):
            kinds.update({prefix + "weight": "bn_w", prefix + "bias": "bn_b",
                          prefix + "running_mean": "bn_mean",
                          prefix + "running_var": "bn_var",
                          prefix + "num_batches_tracked": "count"})
    return [(k, kinds[k], t) for k, t in model.state_dict().items()]


def _std(kind, shape):
    co, ci, kh, kw = shape
    if kind == "conv_w_enc":
        return math.sqrt(2.0 / (co * kh * kw))
    return DECODER_GAIN / math.sqrt(ci * kh * kw)


def seeded_state_dict(template, seed, device):
    """{key: tensor on ``device``} for every state_dict key of ``template``
    (a reference model, on any device, meta included), drawn from ``seed``
    on ``device``.  The same seed gives the same values on the same kind of
    device."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    leaves = _leaves(template)
    out = {}

    def draw(kinds, scale_of):
        """One normal draw for all leaves of ``kinds``, scaled per leaf."""
        group = [(k, kind, t) for k, kind, t in leaves if kind in kinds]
        sizes = [t.numel() for _, _, t in group]
        flat = torch.randn(sum(sizes), generator=gen, device=device)
        scales = torch.tensor([scale_of(kind, t) for _, kind, t in group], device=device)
        flat *= torch.repeat_interleave(scales, torch.tensor(sizes, device=device))
        return group, flat.split(sizes)

    group, parts = draw({"conv_w_enc", "conv_w_dec"}, lambda kind, t: _std(kind, t.shape))
    for (k, _, t), v in zip(group, parts):
        out[k] = v.view(t.shape)
    group, parts = draw({"conv_b", "bn_w", "bn_b", "bn_mean", "bn_var"},
                        lambda kind, t: {"conv_b": 0.05, "bn_w": 0.1, "bn_b": 0.1,
                                         "bn_mean": 0.1, "bn_var": 0.2}[kind])
    for (k, kind, t), v in zip(group, parts):
        if kind == "bn_w":
            v = v + 1.0
        elif kind == "bn_var":
            v = v.exp()
        out[k] = v.view(t.shape)
    for k, kind, t in leaves:
        if kind == "count":
            out[k] = torch.zeros((), dtype=torch.long, device=device)
    return {k: out[k] for k, _, _ in leaves}
