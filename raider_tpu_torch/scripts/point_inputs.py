"""Synthetic inputs of point requests, written from a seed: orbit files (ESA
EOF XML, 7-column text), GNSS station CSVs, radar-coordinate lat/lon
grids with seeded terrain, incidence/heading rasters and GUNW-style
geocubes (netCDF-3 through scipy, so no h5py is needed).

Used by ``chip_smoke.py`` (phase 9) and the port's tests; every writer
produces a file that both the port and the JAX package read.
"""

import csv
import datetime as dt
import os

import numpy as np

EOF_FMT = '%Y%m%dT%H%M%S'


def write_eof(directory, orbit, mission: str = 'S1A') -> str:
    """Write ``orbit``'s statevectors as an ESA EOF XML (positions and
    velocities printed with 6 decimals, times to the microsecond), with a
    Sentinel-1 precise-orbit file name whose validity window runs from an
    hour before the statevectors to an hour after. Returns its path."""
    times = [orbit.ref_time + dt.timedelta(seconds=float(t)) for t in orbit.times]
    t0, t1 = (t.strftime(EOF_FMT) for t in (times[0] - dt.timedelta(hours=1),
                                           times[-1] + dt.timedelta(hours=1)))
    made = (times[-1] + dt.timedelta(days=20)).strftime(EOF_FMT)
    path = os.path.join(str(directory), f'{mission}_OPER_AUX_POEORB_OPOD_{made}_V{t0}_{t1}.EOF')
    osvs = []
    for t, p, v in zip(times, orbit.pos, orbit.vel):
        utc = t.strftime('%Y-%m-%dT%H:%M:%S.%f')
        osvs.append(
            '      <OSV>\n'
            f'        <TAI>TAI={utc}</TAI>\n'
            f'        <UTC>UTC={utc}</UTC>\n'
            f'        <UT1>UT1={utc}</UT1>\n'
            '        <Absolute_Orbit>+1</Absolute_Orbit>\n'
            + ''.join(f'        <{k} unit="m">{x:.6f}</{k}>\n' for k, x in zip(('X', 'Y', 'Z'), p))
            + ''.join(f'        <{k} unit="m/s">{x:.6f}</{k}>\n'
                      for k, x in zip(('VX', 'VY', 'VZ'), v))
            + '        <Quality>NOMINAL</Quality>\n'
            '      </OSV>\n')
    with open(path, 'w') as f:
        f.write('<?xml version="1.0" ?>\n<Earth_Explorer_File>\n'
                '  <Earth_Explorer_Header>\n'
                f'    <Fixed_Header><File_Name>{os.path.basename(path)[:-4]}</File_Name>'
                '</Fixed_Header>\n'
                '  </Earth_Explorer_Header>\n'
                '  <Data_Block type="xml">\n'
                f'    <List_of_OSVs count="{len(osvs)}">\n' + ''.join(osvs)
                + '    </List_of_OSVs>\n  </Data_Block>\n</Earth_Explorer_File>\n')
    return path


def write_txt_orbit(path, orbit) -> str:
    """Write ``orbit`` as 7-column text: ISO time (to the microsecond,
    which every Python's ``fromisoformat`` parses), x y z, vx vy vz."""
    with open(path, 'w') as f:
        for t, p, v in zip(orbit.times, orbit.pos, orbit.vel):
            stamp = orbit.ref_time + dt.timedelta(seconds=float(t))
            stamp = stamp.isoformat(timespec='microseconds')
            f.write(stamp + ' ' + ' '.join(f'{x:.6f}' for x in (*p, *v)) + '\n')
    return str(path)


def write_station_csv(path, lat, lon, hgt=None, n_duplicates: int = 0, seed: int = 0) -> str:
    """A GNSS station CSV (ID, Lat, Lon[, Hgt_m]) with ``n_duplicates`` of
    its rows repeated at seeded places. Values are printed with repr."""
    rng = np.random.default_rng(seed)
    rows = [[f'S{i:05d}', repr(float(a)), repr(float(b))]
            + ([] if hgt is None else [repr(float(h))])
            for i, (a, b, h) in enumerate(zip(lat, lon, lat if hgt is None else hgt))]
    for i in rng.choice(len(rows), size=n_duplicates, replace=False):
        rows.insert(int(rng.integers(0, len(rows) + 1)), list(rows[i]))
    with open(path, 'w', newline='') as f:
        w = csv.writer(f)
        w.writerow(['ID', 'Lat', 'Lon'] + ([] if hgt is None else ['Hgt_m']))
        w.writerows(rows)
    return str(path)


def radar_grid(center, shape, extent_deg, skew_deg: float = 10.0):
    """(lat, lon) float64 grids of a radar-coordinate raster: rows run along
    a track skewed ``skew_deg`` from north, columns across it.
    ``center`` is (lat, lon); ``extent_deg`` the (along, across) extent."""
    lat0, lon0 = center
    ny, nx = shape
    a = np.linspace(-0.5, 0.5, ny)[:, None] * extent_deg[0]
    c = np.linspace(-0.5, 0.5, nx)[None, :] * extent_deg[1]
    sk = np.deg2rad(skew_deg)
    lat = lat0 + a * np.cos(sk) - c * np.sin(sk)
    lon = lon0 + (a * np.sin(sk) + c * np.cos(sk)) / np.cos(np.deg2rad(lat0))
    return lat, lon


def terrain(shape, lo: float, hi: float, seed: int = 0, waves: int = 6):
    """Smooth seeded heights between ``lo`` and ``hi`` (a sum of plane waves)."""
    rng = np.random.default_rng(seed)
    ny, nx = shape
    yy, xx = np.meshgrid(np.linspace(0.0, 1.0, ny), np.linspace(0.0, 1.0, nx), indexing='ij')
    h = np.zeros(shape)
    for _ in range(waves):
        ky, kx = rng.uniform(1.0, 8.0, 2)
        h += np.sin(2 * np.pi * (ky * yy + kx * xx) + rng.uniform(0.0, 2 * np.pi))
    h = (h - h.min()) / (h.max() - h.min())
    return lo + (hi - lo) * h


def inc_hd_from_look(look_enu):
    """Incidence and heading [deg] of (..., 3) ENU unit look vectors (target
    to sensor): the inverse of ``geometry.los.inc_hd_to_enu``."""
    e, n, u = look_enu[..., 0], look_enu[..., 1], look_enu[..., 2]
    inc = np.rad2deg(np.arccos(np.clip(u, -1.0, 1.0)))
    heading = np.rad2deg(np.arctan2(n, e)) - 90.0
    return inc, heading


def write_geocube(path, lats, lons, heights) -> str:
    """A GUNW-style geocube: ``latitude``, ``longitude`` and ``heights``
    coordinates in a netCDF-3 file written by scipy."""
    from scipy.io import netcdf_file

    with netcdf_file(str(path), 'w', version=2) as f:
        for name, vals in (('latitude', lats), ('longitude', lons), ('heights', heights)):
            vals = np.asarray(vals, dtype=np.float64)
            f.createDimension(name, vals.size)
            v = f.createVariable(name, 'f8', (name,))
            v[:] = vals
    return str(path)
