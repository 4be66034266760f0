"""Weather-model layer: the model readers, ``prepareWeatherModel`` and the
refractivity preprocessing pipeline on tensors."""

from raider_tpu_torch.wx.base import WeatherModel, fillna3d, find_svp  # noqa: F401
from raider_tpu_torch.wx.exceptions import (  # noqa: F401
    CriticalError,
    DatetimeFailed,
    DatetimeNotAvailable,
    DatetimeOutsideRange,
    ExistingWeatherModelTooSmall,
    NoStationDataFoundError,
    NoWeatherModelData,
    TryToKeepGoingError,
    WrongNumberOfFiles,
)
