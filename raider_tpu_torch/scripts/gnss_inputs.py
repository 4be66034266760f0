"""Synthetic UNR GNSS troposphere archives, written from a seed.

A UNR archive ``<ID>.<year>.trop.zip`` holds one gzipped SINEX-trop file a
day (``<ID>.<year>.<doy>.trop.gz``): a ``+TROP/SOLUTION`` block with one
line an epoch (``SITE YY:DOY:SSSSS TROTOT STDDEV TRWET ...``, delays in
mm) on the 300 s grid, a few epochs missing as in real archives. Used by
``chip_smoke.py`` (phase 11b) and the port's tests; both the port and the
JAX package parse what it writes.
"""

import gzip
import zipfile

import numpy as np

EPOCHS = np.arange(0, 86400, 300)


def trop_day(station: str, year: int, doy: int, rng, n_gaps: int = 0) -> tuple:
    """One day's SINEX-trop text and its values: (text, times, TROTOT,
    STDDEV, TRWET), the values (mm) as the text prints them, ``n_gaps``
    epochs left out at places drawn from ``rng``."""
    gaps = set(rng.choice(EPOCHS.size, size=n_gaps, replace=False).tolist()) if n_gaps else set()
    keep = np.array([k not in gaps for k in range(EPOCHS.size)])
    k = np.arange(EPOCHS.size)
    trotot = np.round(2300.0 + 80.0 * rng.uniform() + 15.0 * np.sin(2 * np.pi * k / 288.0
                                                                    + rng.uniform(0, 6.3)), 1)
    sd = np.round(rng.uniform(0.5, 2.0, EPOCHS.size), 1)
    trwet = np.round(60.0 + 150.0 * rng.uniform() + 10.0 * np.cos(2 * np.pi * k / 144.0), 1)
    lines = ['%=TRO 0.01 NGL 00:000:00000 NGL 00:000:00000 00:000:00000 P MIX\n',
             '+TROP/SOLUTION\n',
             '*SITE ____EPOCH___ TROTOT STDDEV  TRWET  TGETOT STDDEV TGNTOT STDDEV WVAPOR '
             'STDDEV  MTEMP\n']
    for i in np.flatnonzero(keep):
        lines.append(f' {station} {year % 100:02d}:{doy:03d}:{EPOCHS[i]:05d} {trotot[i]:.1f} '
                     f'{sd[i]:.1f} {trwet[i]:.1f} 0.2 0.1 -0.3 0.1 12.0 0.5 280.0\n')
    lines.append('-TROP/SOLUTION\n%=ENDTRO\n')
    printed = [np.array([float(f'{v:.1f}') for v in a[keep]]) for a in (trotot, sd, trwet)]
    return (''.join(lines), EPOCHS[keep], *printed)


def write_trop_zip(path, station: str, year: int, doys, seed: int = 0, n_gaps: int = 3) -> dict:
    """Write a UNR archive of ``station`` for ``year`` holding the days
    ``doys``; returns {doy: (times, TROTOT, STDDEV, TRWET)} as written."""
    rng = np.random.default_rng(seed)
    out = {}
    with zipfile.ZipFile(path, 'w') as z:
        for doy in doys:
            text, *values = trop_day(station, year, doy, rng, n_gaps)
            z.writestr(f'{station}.{year}.{doy:03d}.trop.gz', gzip.compress(text.encode(), 6))
            out[doy] = tuple(values)
    return out
