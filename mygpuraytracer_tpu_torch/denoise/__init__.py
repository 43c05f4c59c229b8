from .tza import read_tza
from .unet import UNET_ALIGNMENT, UNet, params_from_jax, unet_apply
