"""The weather-model errors (counterpart of ``raider_tpu/wx/exceptions.py``)."""

import datetime as dt


class DatetimeFailed(Exception):
    def __init__(self, model: str = '', time: 'dt.datetime | None' = None) -> None:
        super().__init__(f'Weather model {model} failed to download for datetime {time}')


class DatetimeNotAvailable(Exception):
    def __init__(self, model: str = '', time: 'dt.datetime | None' = None) -> None:
        super().__init__(f'Weather model {model} was not found for datetime {time}')


class DatetimeOutsideRange(Exception):
    def __init__(self, model: str = '', time: 'dt.datetime | None' = None) -> None:
        msg = f'Time {time} is outside the available date range for weather model {model}'
        super().__init__(msg)


class ExistingWeatherModelTooSmall(Exception):
    def __init__(self) -> None:
        super().__init__(
            'The weather model passed does not cover all of the input points; '
            'you may need to download a larger area.'
        )


class TryToKeepGoingError(Exception):
    def __init__(self, date=None) -> None:
        msg = f'Date {date} is not available' if date else 'The current date is not available'
        super().__init__(msg)


class CriticalError(Exception):
    def __init__(self) -> None:
        super().__init__('I have experienced a critical error, please take a look at the log files')


class WrongNumberOfFiles(Exception):
    def __init__(self, expected: int = 0, received: int = 0) -> None:
        super().__init__(f'The number of files received {received} does not match the expected number {expected}')


class NoWeatherModelData(Exception):
    def __init__(self, custom_msg=None) -> None:
        super().__init__(custom_msg or 'No weather model data available for the queried region/time')


class NoStationDataFoundError(Exception):
    def __init__(self, station_list=None, years=None) -> None:
        msg = 'No GNSS station data was found'
        if station_list:
            msg += f' for stations {station_list}'
        if years:
            msg += f' and years {years}'
        super().__init__(msg)
