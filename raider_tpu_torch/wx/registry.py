"""Weather-model registry (counterpart of ``raider_tpu/wx/registry.py``)."""

from typing import Tuple, Type

from raider_tpu_torch.wx.base import WeatherModel

ALLOWED_MODELS = [
    'ERA5',
    'ERA5T',
    'ERAI',
    'HRES',
    'HRRR',
    'HRRRAK',
    'GMAO',
    'MERRA2',
    'NCMR',
    'WRF',
]


def get_wm_by_name(model_name: str) -> Tuple[str, Type[WeatherModel]]:
    """Resolve a model name like 'ERA-5' to its class."""
    name = model_name.upper().replace('-', '')
    from raider_tpu_torch.wx import ecmwf, gmao, hrrr, merra2, ncmr, wrf

    registry = {
        'ERA5': ecmwf.ERA5,
        'ERA5T': ecmwf.ERA5T,
        'ERAI': ecmwf.ERAI,
        'HRES': ecmwf.HRES,
        'HRRR': hrrr.HRRR,
        'HRRRAK': hrrr.HRRRAK,
        'GMAO': gmao.GMAO,
        'MERRA2': merra2.MERRA2,
        'NCMR': ncmr.NCMR,
        'WRF': wrf.WRF,
    }
    try:
        cls = registry[name]
    except KeyError:
        raise ModuleNotFoundError(f'Unknown weather model: {model_name}')
    # the class's REAL defining module (several models share ecmwf.py/hrrr.py)
    return cls.__module__, cls
