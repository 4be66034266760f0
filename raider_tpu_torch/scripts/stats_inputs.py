"""Synthetic combined GNSS/model delay CSVs for raiderStats (seeded, numpy).

``write_combined_csv`` writes the table ``gnss_combine`` (raiderCombine)
writes: ID, Lat, Lon, Hgt_m, Datetime, wetDelay, hydroDelay, totalDelay,
ZTD, sigZTD, ZTD_minus_RAiDER, one row per station and epoch. Each
station's ZTD is 2.3 m plus an annual and a semiannual harmonic at a seeded
amplitude and phase, a trend and white noise; a share of the station-days
is missing (never a station's first or last), and some stations hold less
than two years of record. Returns the truth: the harmonics in the
convention of ``workflows.stats.seasonal_fit`` (a sin + b cos =
A sin(x + phase), t in years from the whole year at or before the first
epoch).
"""

import numpy as np

SECONDS_PER_YEAR = 365.25 * 86400.0


def write_combined_csv(path, n_stations: int = 2000, n_days: int = 760,
                       start: str = '2019-01-01T12:00:00', missing: float = 0.05,
                       n_short: int = 50, box=(25.0, 49.0, -124.0, -67.0), seed: int = 0,
                       noise_m: float = 0.01) -> dict:
    """Write the CSV; returns a dict of per-station truth arrays (ID, Lat,
    Lon, annual and semiannual amplitude and phase, trend, short) and the
    fit epoch ``t_ref`` (seconds), with ``rows`` the number of rows."""
    rng = np.random.default_rng(seed)
    s, n, w, e = box
    lat = rng.uniform(s, n, n_stations)
    lon = rng.uniform(w, e, n_stations)
    hgt = rng.uniform(0.0, 2000.0, n_stations)
    amp1 = rng.uniform(0.02, 0.06, n_stations)
    amp2 = rng.uniform(0.005, 0.015, n_stations)
    ph1 = rng.uniform(-np.pi, np.pi, n_stations)
    ph2 = rng.uniform(-np.pi, np.pi, n_stations)
    trend = rng.uniform(-0.003, 0.003, n_stations)
    short = np.zeros(n_stations, dtype=bool)
    short[rng.choice(n_stations, n_short, replace=False)] = True
    first = np.zeros(n_stations, dtype=np.int64)
    length = np.full(n_stations, n_days, dtype=np.int64)
    length[short] = rng.integers(200, 700, n_short)
    first[short] = rng.integers(0, n_days - length[short] + 1)
    # one station of full record starts on the first day, so t_ref is fixed
    start_s = np.datetime64(start, 's').astype(np.int64)
    t_ref = np.floor(start_s / SECONDS_PER_YEAR) * SECONDS_PER_YEAR

    st, day = [], []
    for k in range(n_stations):
        d = np.arange(first[k], first[k] + length[k])
        keep = rng.random(d.size) >= missing
        keep[0] = keep[-1] = True
        st.append(np.full(int(keep.sum()), k))
        day.append(d[keep])
    st, day = np.concatenate(st), np.concatenate(day)
    t = start_s + day * 86400
    t_yr = (t - t_ref) / SECONDS_PER_YEAR
    ztd = (2.3 + amp1[st] * np.sin(2 * np.pi * t_yr + ph1[st])
           + amp2[st] * np.sin(4 * np.pi * t_yr + ph2[st]) + trend[st] * t_yr
           + rng.normal(0.0, noise_m, st.size))
    sig = rng.uniform(0.001, 0.02, st.size)
    total = ztd + rng.normal(0.0, 0.02, st.size)
    wet = 0.1 * total + rng.normal(0.0, 0.005, st.size)
    hydro = total - wet
    when = np.datetime_as_string(t.astype('datetime64[s]'), unit='s')
    ids = np.array([f'S{k:05d}' for k in range(n_stations)])
    # values rounded to a few decimals write short texts, which every CSV
    # parser (pandas' too) reads back as the same doubles
    cols = [ids[st], *(np.round(a, 6)[st].astype(str) for a in (lat, lon)),
            np.round(hgt, 3)[st].astype(str), np.char.replace(when, 'T', ' ')]
    cols += [np.round(v, 9).astype(str) for v in (wet, hydro, total, ztd, sig, ztd - total)]
    with open(path, 'w') as f:
        f.write('ID,Lat,Lon,Hgt_m,Datetime,wetDelay,hydroDelay,totalDelay,ZTD,sigZTD,'
                'ZTD_minus_RAiDER\n')
        f.write('\n'.join(map(','.join, zip(*(c.tolist() for c in cols)))))
        f.write('\n')
    return dict(ID=ids, Lat=lat, Lon=lon, annual_amplitude=amp1, annual_phase=ph1,
                semiannual_amplitude=amp2, semiannual_phase=ph2, trend=trend, short=short,
                t_ref=float(t_ref), rows=int(st.size))
