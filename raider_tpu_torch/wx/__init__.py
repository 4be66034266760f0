"""Weather-model layer: the refractivity preprocessing pipeline on tensors."""

from raider_tpu_torch.wx.base import WeatherModel, fillna3d, find_svp  # noqa: F401
