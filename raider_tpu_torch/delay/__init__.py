"""Delay engine: zenith and raytraced-slant tropospheric delay cubes."""

from raider_tpu_torch.delay.engine import WeatherCube, tropo_delay  # noqa: F401
