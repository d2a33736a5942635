"""Weight conversion (counterpart of footprints_tpu/convert/):

  bridge.py              JAX params/state pytrees <-> the port's state_dict
                         (both models), and the JAX flat order of Adam's
                         moments;
  torchvision_resnet.py  ``--pretrained_encoder``: an encoder from a local
                         torchvision or reference ``.pth``;
  cli.py                 ``python -m footprints_tpu_torch.convert.cli``:
                         a reference ``.pth`` -> ``checkpoint.npz``.
"""

from .bridge import (flat_from_named, jax_params_from_state_dict, named_from_flat,
                     ravel_params, segmentor_jax_params_from_state_dict,
                     segmentor_state_dict_from_jax_params, state_dict_from_jax_params,
                     unravel_params)
from .torchvision_resnet import (encoder_from_torchvision_state_dict, init_encoder_from,
                                 load_pretrained_encoder, load_state_dict_file,
                                 resolve_pretrained_encoder)

__all__ = ["encoder_from_torchvision_state_dict", "flat_from_named", "init_encoder_from",
           "jax_params_from_state_dict", "load_pretrained_encoder", "load_state_dict_file",
           "named_from_flat", "ravel_params", "resolve_pretrained_encoder",
           "segmentor_jax_params_from_state_dict", "segmentor_state_dict_from_jax_params",
           "state_dict_from_jax_params", "unravel_params"]
