from .tza import read_tza
from .filter import Device, DeviceBuffer, Filter, OidnError, RTFilter, RTLightmapFilter
from .unet import UNET_ALIGNMENT, UNet, params_from_jax, unet_apply
