"""Date/time helpers (counterpart of ``raider_tpu/utils/timeutils.py``)."""

import datetime as dt
import re
from typing import List, Union

import numpy as np

from raider_tpu_torch.constants import _THRESHOLD_SECONDS


def round_date(date: dt.datetime, precision: dt.timedelta) -> dt.datetime:
    """Round to the nearest multiple of ``precision``."""
    t0 = dt.datetime.min
    if date.tzinfo is not None:
        t0 = t0.replace(tzinfo=dt.timezone.utc)
    rem_up = (t0 - date) % precision
    round_up = date + rem_up
    rem_down = (date - t0) % precision
    round_down = date - rem_down
    return round_up if (round_up - date) < (date - round_down) else round_down


def round_time(datetime: dt.datetime, roundTo: int = 60) -> dt.datetime:
    """Round a datetime to the nearest ``roundTo`` seconds."""
    seconds = (datetime.replace(tzinfo=None) - datetime.min).seconds
    rounding = (seconds + roundTo / 2) // roundTo * roundTo
    return datetime + dt.timedelta(0, rounding - seconds, -datetime.microsecond)


def get_dt(t1: dt.datetime, t2: dt.datetime) -> float:
    """Absolute difference in seconds."""
    return float(np.abs((t1 - t2).total_seconds()))


def get_nearest_wmtimes(t0: dt.datetime, time_delta: int) -> List[dt.datetime]:
    """The one or two nearest model epochs to ``t0`` given a step in hours."""
    tclose = round_time(t0, roundTo=time_delta * 60 * 60)
    t2_1 = tclose + dt.timedelta(hours=time_delta)
    t2_2 = tclose - dt.timedelta(hours=time_delta)
    t2 = t2_1 if get_dt(t2_1, t0) < get_dt(t2_2, t0) else t2_2

    if get_dt(tclose, t0) < _THRESHOLD_SECONDS:
        return [tclose]
    return [tclose, t2] if t2 > tclose else [t2, tclose]


def getTimeFromFile(filename: Union[str, 'object']) -> dt.datetime:
    """Parse the datetime embedded in a weather filename."""
    fmt = '%Y_%m_%d_T%H_%M_%S'
    p = re.compile(r'\d{4}_\d{2}_\d{2}_T\d{2}_\d{2}_\d{2}')
    out = p.search(str(filename)).group()
    return dt.datetime.strptime(out, fmt)


def floorish(val, frac):
    """Round down to the nearest fractional step."""
    return val - (val % frac)
