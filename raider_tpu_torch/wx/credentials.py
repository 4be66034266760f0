"""Weather-model API credential management.

Counterpart of ``raider_tpu/wx/credentials.py``. Writes the rc files each
provider's client expects, from explicit arguments or environment variables.
"""

import os
from pathlib import Path
from typing import Optional

from raider_tpu_torch.logger import logger

# model name -> (rc filename, env var names)
RC_FILENAMES = {
    'ERA5': '.cdsapirc',
    'ERA5T': '.cdsapirc',
    'HRES': '.ecmwfapirc',
    'GMAO': '.netrc',
    'MERRA2': '.netrc',
    'HRRR': None,   # AWS open data, no credentials
    'HRRRAK': None,
    'NCMR': '.ncmrlogin',
}

ENV_VARS = {
    '.cdsapirc': ('RAIDER_ECMWF_ERA5_UID', 'RAIDER_ECMWF_ERA5_API_KEY'),
    '.ecmwfapirc': ('RAIDER_HRES_EMAIL', 'RAIDER_HRES_API_KEY'),
    '.netrc': ('EARTHDATA_USERNAME', 'EARTHDATA_PASSWORD'),
}

_HRES_URL = 'https://api.ecmwf.int/v1'
_CDS_URL = 'https://cds.climate.copernicus.eu/api'


def _rc_path(filename: str) -> Path:
    return Path.home() / filename


def check_api(
    model: str,
    uid: Optional[str] = None,
    key: Optional[str] = None,
    output_dir: Optional[str] = None,
    update_rc_file: bool = False,
) -> None:
    """Ensure the rc file for ``model`` exists, writing it if credentials are
    provided."""
    model = model.upper().replace('-', '')
    rc_filename = RC_FILENAMES.get(model, None)
    if rc_filename is None:
        return

    rc_file = Path(output_dir) / rc_filename if output_dir else _rc_path(rc_filename)

    # never overwrite an existing credentials file unless explicitly asked
    if rc_file.exists() and not update_rc_file:
        return

    if uid is None or key is None:
        env_uid_var, env_key_var = ENV_VARS[rc_filename] if rc_filename in ENV_VARS else (None, None)
        uid = uid or (os.environ.get(env_uid_var) if env_uid_var else None)
        key = key or (os.environ.get(env_key_var) if env_key_var else None)

    if uid is None or key is None:
        if rc_file.exists():
            return
        raise ValueError(
            f'No credentials found for model {model}: pass uid/key, set the '
            f'environment variables, or create {rc_file}.'
        )

    if rc_filename == '.cdsapirc':
        rc_file.write_text(f'url: {_CDS_URL}\nkey: {key}\n')
    elif rc_filename == '.ecmwfapirc':
        rc_file.write_text(
            '{\n'
            f'    "url"   : "{_HRES_URL}",\n'
            f'    "key"   : "{key}",\n'
            f'    "email" : "{uid}"\n'
            '}\n'
        )
    elif rc_filename == '.netrc':
        existing = rc_file.read_text() if rc_file.exists() else ''
        if 'urs.earthdata.nasa.gov' not in existing:
            with rc_file.open('a') as f:
                f.write(f'\nmachine urs.earthdata.nasa.gov\n\tlogin {uid}\n\tpassword {key}\n')
    elif rc_filename == '.ncmrlogin':
        # the NCMRWF outgoing server; users with a different data agreement
        # can edit the url line afterwards
        rc_file.write_text('url: https://ftp.ncmrwf.gov.in/pub/outgoing/SAC/NCUM_OSF\n'
                           f'username: {uid}\npassword: {key}\n')
    try:
        rc_file.chmod(0o600)
    except OSError:
        pass
    logger.info('Wrote credentials to %s', rc_file)


def setup_from_env() -> None:
    """Write any rc files derivable from environment variables."""
    for model, rc in RC_FILENAMES.items():
        if rc is None:
            continue
        try:
            check_api(model)
        except ValueError:
            pass
