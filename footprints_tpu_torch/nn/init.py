"""Parameter initialisers matching torch defaults (counterpart of
footprints_tpu/nn/init.py), drawn from an explicit ``torch.Generator``.

  * decoder convs: torch.nn.Conv2d default = kaiming_uniform(a=sqrt(5))
    -> U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weights and bias
  * resnet convs: kaiming_normal(fan_out, relu) (torchvision convention)
  * batchnorm: weight=1, bias=0, running mean=0, var=1

Values are drawn on the CPU and copied to the parameter's device, so one
seed gives the same weights on every device.
"""

import math

import torch


def _fill(param, values):
    with torch.no_grad():
        param.copy_(values.to(device=param.device, dtype=param.dtype))


def conv_kaiming_uniform_(conv, generator):
    """torch.nn.Conv2d default init, weight and bias."""
    c_out, c_in, kh, kw = conv.weight.shape
    bound = 1.0 / math.sqrt(c_in * kh * kw)
    w = torch.empty(conv.weight.shape).uniform_(-bound, bound, generator=generator)
    _fill(conv.weight, w)
    if conv.bias is not None:
        _fill(conv.bias, torch.empty(c_out).uniform_(-bound, bound,
                                                     generator=generator))


def conv_kaiming_normal_fanout_(conv, generator):
    """torchvision ResNet conv init: N(0, sqrt(2/fan_out)), zero bias."""
    c_out, _, kh, kw = conv.weight.shape
    std = math.sqrt(2.0 / (c_out * kh * kw))
    _fill(conv.weight, torch.empty(conv.weight.shape).normal_(
        0.0, std, generator=generator))
    if conv.bias is not None:
        _fill(conv.bias, torch.zeros(c_out))


def batchnorm_(bn):
    """BN params and running stats at identity."""
    with torch.no_grad():
        bn.weight.fill_(1.0)
        bn.bias.fill_(0.0)
        bn.running_mean.fill_(0.0)
        bn.running_var.fill_(1.0)
        bn.num_batches_tracked.fill_(0)
